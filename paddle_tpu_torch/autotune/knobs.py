"""Tuning-knob resolution: the one place kernel and runtime tuning
parameters come from — the port of ``paddle_tpu/autotune/knobs.py``.

Resolution order, strongest first:

  1. **active trial override** — the measurement harness pins the
     candidate's parameters for the duration of one trial
     (:func:`trial_overrides`); nothing may shadow the A/B being run;
  2. **environment** — the explicit operator override layer
     (PADDLE_TPU_BNCONV_VARIANT, PADDLE_TPU_PAGE_SIZE, ...).  Values are
     VALIDATED here: garbage raises a clear error naming the variable;
  3. **winner store** — the persisted measured winner for this site on
     this device and backend (:mod:`paddle_tpu_torch.autotune.store`);
  4. the caller's **default**.

Each call reads the environment afresh.  Knob names are dotted
``<namespace>.<field>`` strings; the namespace is also the store's
kernel-site kind (``bn_conv``, ``paged_attention``, ``spec_decode``,
``step_loop``).  The JAX package's flash-attention block knob has no
counterpart: the port's K1 and K4–K6 bodies take no block size.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Tuple

from . import store as _store

_tls = threading.local()


class trial_overrides:
    """Context manager pinning knob values for one measurement trial.

    ``mapping`` uses dotted knob names (``{"bn_conv.variant": "v2"}``).
    Nesting stacks; inner wins.  Also the harness-active signal
    :func:`in_trial` — program-winner auto-application (integration.py)
    stands down during a trial so a stored winner can never contaminate
    the A/B measuring its successor."""

    def __init__(self, mapping: Optional[Dict[str, object]] = None,
                 **kv):
        self._mapping = dict(mapping or {})
        self._mapping.update(kv)

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self._mapping)
        return self

    def __exit__(self, *exc):
        _tls.stack.pop()
        return False


def in_trial() -> bool:
    return bool(getattr(_tls, "stack", None))


def _trial_value(name: str):
    for frame in reversed(getattr(_tls, "stack", []) or []):
        if name in frame:
            return frame[name]
    return None


def platform(init: bool = False) -> Tuple[str, str]:
    """(device_kind, backend) — the store's platform tag:
    (``torch.cuda.get_device_name(0)``, "cuda") on the card, ("cpu",
    "cpu") without one.  Without `init` a process whose CUDA is not
    initialized yet gets ("unknown", "none") and nothing is initialized
    (an executor-run lookup before the first device touch); the tuner
    passes init=True, since it is about to measure on that device."""
    import torch

    if not torch.cuda.is_available():
        return ("cpu", "cpu")
    if not init and not torch.cuda.is_initialized():
        return ("unknown", "none")
    return (torch.cuda.get_device_name(0), "cuda")


def _env_int(var: str, what: str) -> Optional[int]:
    raw = os.environ.get(var)
    if raw is None or raw == "":
        return None
    try:
        val = int(raw)
    except ValueError:
        raise ValueError(
            f"{var}={raw!r} is not an integer ({what}); unset it or "
            f"give a positive number of elements") from None
    if val <= 0:
        raise ValueError(
            f"{var}={val} must be a positive integer ({what})")
    return val


def _site_winner(ns: str, site: Dict[str, object]) -> Dict[str, object]:
    kind, backend = platform()
    w = _store.default_store().winner(ns, site, kind, backend)
    return w or {}


# ---------------------------------------------------------------------------
# domain knobs (each documents its env override + validation contract;
# all follow the module-docstring resolution order)


_BNCONV_VARIANTS = ("v1", "v2", "reference")


def bnconv_variant() -> str:
    """The fused 3x3 forward: "v1" (K13), "v2" (K14, O-blocked) or
    "reference" (the unfused composition, with autograd).  Trial override
    > PADDLE_TPU_BNCONV_VARIANT > legacy PADDLE_TPU_BNCONV_V2=1 > stored
    winner > "v1"."""
    v = _trial_value("bn_conv.variant")
    if v is None:
        raw = os.environ.get("PADDLE_TPU_BNCONV_VARIANT")
        if raw not in (None, ""):
            if raw not in _BNCONV_VARIANTS:
                raise ValueError(
                    f"PADDLE_TPU_BNCONV_VARIANT={raw!r}: use one of "
                    f"{_BNCONV_VARIANTS}")
            v = raw
        elif os.environ.get("PADDLE_TPU_BNCONV_V2") == "1":
            v = "v2"  # the legacy A/B switch, kept as an explicit override
    if v is None:
        v = _site_winner("bn_conv", {}).get("variant")
    v = v or "v1"
    if v not in _BNCONV_VARIANTS:
        raise ValueError(f"bn_conv.variant {v!r}: use one of "
                         f"{_BNCONV_VARIANTS}")
    return v


def bnconv_block_o() -> int:
    """Explicit K14 O-block override (0 = let the kernel pick).  Trial
    override > PADDLE_TPU_BNCONV_BO (validated; "0" is the documented
    no-override sentinel, not an error) > stored winner > 0."""
    v = _trial_value("bn_conv.block_o")
    if v is None:
        if os.environ.get("PADDLE_TPU_BNCONV_BO") == "0":
            return 0  # the sentinel: defer to the kernel's rule
        v = _env_int("PADDLE_TPU_BNCONV_BO", "bn-conv v2 weight O-block")
    if v is None:
        v = _site_winner("bn_conv", {}).get("block_o")
    return int(v or 0)


def paged_page_size(default: int = 16) -> int:
    """KV-cache page size (tokens per page; the paged-attention kernels'
    unit of work).  Trial override > PADDLE_TPU_PAGE_SIZE (validated) >
    stored winner > `default`.  An environment value must be a multiple
    of 16, as in the JAX package."""
    v = _trial_value("paged_attention.page_size")
    if v is None:
        v = _env_int("PADDLE_TPU_PAGE_SIZE", "KV page size in tokens")
        if v is not None and v % 16:
            raise ValueError(
                f"PADDLE_TPU_PAGE_SIZE={v} must be a multiple of 16 "
                f"(whole sublane tiles for every pool dtype)")
    if v is None:
        v = _site_winner("paged_attention", {}).get("page_size")
    return int(v or default)


def speculation_k(default: int = 4) -> int:
    """Speculative-decoding depth K (draft tokens proposed per round;
    serving/speculative.py).  Trial override > PADDLE_TPU_SPEC_K
    (validated positive int) > stored ``spec_decode`` winner >
    `default`."""
    v = _trial_value("spec_decode.speculation_k")
    if v is None:
        v = _env_int("PADDLE_TPU_SPEC_K", "speculation depth in tokens")
    if v is None:
        v = _site_winner("spec_decode", {}).get("speculation_k")
    return int(v or default)


def steps_per_dispatch(default: int = 1, store: bool = True) -> int:
    """Steps one ``Executor.run`` dispatch takes (framework/step_loop.py).
    Trial override > PADDLE_TPU_STEPS_PER_DISPATCH (validated positive
    int) > stored ``step_loop`` winner > `default`.

    ``store=False`` skips the winner lookup — Executor.run's default path
    uses it, because K>1 changes run()'s return contract (stacked
    fetches) and a persisted winner must never silently reshape a
    caller's results; only the explicit arg/env opt-ins may fuse."""
    v = _trial_value("step_loop.steps_per_dispatch")
    if v is None:
        v = _env_int("PADDLE_TPU_STEPS_PER_DISPATCH",
                     "fused steps per dispatch")
    if v is None and store:
        v = _site_winner("step_loop", {}).get("steps_per_dispatch")
    return int(v or default)


def spec_draft_layers(default: int) -> int:
    """Draft-tower depth for self-speculation (the target's first N
    blocks; serving/speculative.py).  Trial override >
    PADDLE_TPU_SPEC_DRAFT_LAYERS (validated positive int) > stored
    ``spec_decode`` winner > `default`.  Callers clamp to the target's
    depth."""
    v = _trial_value("spec_decode.draft_layers")
    if v is None:
        v = _env_int("PADDLE_TPU_SPEC_DRAFT_LAYERS",
                     "draft tower depth in layers")
    if v is None:
        v = _site_winner("spec_decode", {}).get("draft_layers")
    return int(v or default)
