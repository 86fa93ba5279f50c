"""paddle.utils.merge_model (reference utils/merge_model.py), the port of
``paddle_tpu/utils/merge_model.py``: bundle a saved inference model (desc
+ parameters) into one deployable file, the operation `paddle
merge_model` runs from the CLI (``io.merge_model``)."""

from __future__ import annotations

from .. import io


def merge_v2_model(net_file_or_dir, param_file=None, output_file=None):
    """Reference signature merge_v2_model(net, param_file, output_file);
    the saved-inference-model DIRECTORY carries both pieces, so the first
    argument alone suffices.  param_file is an INPUT in the reference API
    and is never written to."""
    return io.merge_model(net_file_or_dir, output_file or "model.merged")


merge_model = merge_v2_model
