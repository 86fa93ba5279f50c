"""The model zoo: the port's counterparts of the JAX package's benchmark
and book models."""

from . import deepfm  # noqa: F401
from . import image_models  # noqa: F401
from . import resnet  # noqa: F401
from . import seq2seq  # noqa: F401
from . import transformer  # noqa: F401
from . import vgg  # noqa: F401
