"""v2 attrs, the port of ``paddle_tpu/v2/attr.py`` (reference
python/paddle/v2/attr.py): the port's v1 attributes under their v2 names."""

from ..v1.attrs import (ExtraAttr as Extra,  # noqa: F401
                        ExtraLayerAttribute as ExtraAttribute,
                        ParamAttr as Param,
                        ParameterAttribute as ParamAttribute)
