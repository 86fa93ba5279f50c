"""`paddle.trainer` namespace (reference python/paddle/trainer/): the
config parser + PyDataProvider2 import surface of v1 scripts.

The heavy machinery lives elsewhere (the Program IS the parsed config —
v1/layers.py parse_network; the @provider decorator — v1/data_provider.py);
these modules keep the reference import paths working."""

from . import PyDataProvider2  # noqa: F401
from . import config_parser  # noqa: F401
