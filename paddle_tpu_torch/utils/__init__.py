"""Tooling package, the port of ``paddle_tpu/utils/`` (reference
python/paddle/utils/): image preprocessing, log-curve plotting, proto
dumping, model merging, torch parameter import.

Mapping to the reference tool scripts:
- image_util / preprocess_img -> `image_util` (the v2 image utilities) +
  `preprocess_img.ImageClassificationDatasetCreater`
- plotcurve -> `plotcurve.plot_paddle_curve`
- show_pb -> `show_pb.dump_program`
- merge_model -> merge_model.merge_v2_model (io.merge_model backed)
- dump_config -> dump_config.dump_config (the `paddle dump_config` path)
- make_model_diagram -> make_model_diagram.make_diagram (net_drawer)
- torch2paddle -> `torch2paddle.torch_state_to_scope`

matplotlib and PIL are imported inside the functions that use them.
"""

from ..v2 import image as image_util  # noqa: F401
from . import dump_config  # noqa: F401
from . import make_model_diagram  # noqa: F401
from . import merge_model  # noqa: F401
from . import plotcurve  # noqa: F401
from . import preprocess_img  # noqa: F401
from . import show_pb  # noqa: F401
from . import torch2paddle  # noqa: F401
