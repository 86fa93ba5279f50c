"""Tunable knobs, the environment layer of
``paddle_tpu/autotune/knobs.py``'s ``bnconv_variant`` and
``steps_per_dispatch``.  The JAX
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


def steps_per_dispatch(default: int = 1, store: bool = False) -> int:
    """Steps one ``Executor.run`` dispatch takes (framework/step_loop.py),
    from PADDLE_TPU_STEPS_PER_DISPATCH (a positive integer), else
    `default`.  The port has no stored winners, so ``store=True`` is
    refused rather than ignored."""
    if store:
        raise NotImplementedError(
            "steps_per_dispatch(store=True): stored autotune winners are "
            "not ported (ROADMAP.md Queue A item 10)")
    var = "PADDLE_TPU_STEPS_PER_DISPATCH"
    raw = os.environ.get(var)
    if raw in (None, ""):
        return int(default)
    try:
        val = int(raw)
    except ValueError:
        raise ValueError(
            f"{var}={raw!r} is not an integer (fused steps per dispatch); "
            f"unset it or give a positive number") from None
    if val <= 0:
        raise ValueError(f"{var}={val} must be a positive integer (fused "
                         f"steps per dispatch)")
    return val
