"""Tunable kernel knobs, the environment layer of
``paddle_tpu/autotune/knobs.py``'s ``bnconv_variant``.  The JAX
resolution order is trial override > the environment > stored winner >
default; the port has the environment and the default only (trial
overrides, stored winners and the other knobs come with the autotune
item, ROADMAP.md Queue A item 10).  Each call reads the environment
afresh, so a test can set the variable between calls."""

from __future__ import annotations

import os

_BNCONV_VARIANTS = ("v1", "v2", "reference")


def bnconv_variant() -> str:
    """The fused 3x3 forward: "v1" (K13, the default), "v2" (K14, the
    O-blocked variant) or "reference" (the unfused composition, with
    autograd), from PADDLE_TPU_BNCONV_VARIANT."""
    raw = os.environ.get("PADDLE_TPU_BNCONV_VARIANT")
    if raw in (None, ""):
        return "v1"
    if raw not in _BNCONV_VARIANTS:
        raise ValueError(f"PADDLE_TPU_BNCONV_VARIANT={raw!r}: use one of "
                         f"{_BNCONV_VARIANTS}")
    return raw
