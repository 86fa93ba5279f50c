"""Typed search space for the analyzer-guided autotuner — the port of
``paddle_tpu/autotune/space.py``.

A :class:`SearchSpace` is an ordered set of named :class:`Choice` axes;
its cartesian product enumerates :class:`Candidate` configurations.
Axis names follow the knob convention (``<namespace>.<field>`` for
kernel knobs resolved through :mod:`paddle_tpu_torch.autotune.knobs`),
plus one program-level axis the measurement harness interprets itself:

  * ``remat`` — bool; True applies the desc-level blanket
    rematerialization pass (``memory_optimize(level=1)``) to the built
    program, exactly what the executor's winner pickup re-applies.

The JAX package's ``xla_flags`` axis (XLA compiler flags) and its
flash-attention block axes have no counterpart here: the port compiles
no XLA, and its K1 and K4–K6 bodies take no block size.
"""

from __future__ import annotations

import hashlib
import itertools
import json
from typing import Dict, List, Sequence

# axes whose effect is program-level, not a kernel knob
PROGRAM_AXES = ("remat",)


class Choice:
    """One named axis with a finite value tuple (first value = the
    default configuration's setting)."""

    __slots__ = ("name", "values")

    def __init__(self, name: str, values: Sequence):
        if not values:
            raise ValueError(f"axis {name!r} has no values")
        self.name = name
        self.values = tuple(values)

    def __repr__(self):
        return f"Choice({self.name!r}, {self.values!r})"


class Candidate:
    """One point of the space: a params dict + stable digest."""

    __slots__ = ("params", "digest")

    def __init__(self, params: Dict[str, object]):
        self.params = dict(params)
        blob = json.dumps(self.params, sort_keys=True,
                          separators=(",", ":"), default=str)
        self.digest = hashlib.sha256(blob.encode()).hexdigest()[:12]

    def knob_params(self) -> Dict[str, object]:
        """The kernel-knob subset (dotted names) — what a trial pins via
        ``knobs.trial_overrides``."""
        return {k: v for k, v in self.params.items()
                if k not in PROGRAM_AXES}

    def get(self, name, default=None):
        return self.params.get(name, default)

    def describe(self) -> str:
        return ",".join(f"{k}={v}" for k, v in sorted(self.params.items())
                        if v not in ("", None))

    def __repr__(self):
        return f"Candidate({self.describe() or 'default'})"


class SearchSpace:
    def __init__(self, axes: Sequence[Choice]):
        names = [a.name for a in axes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate axis names in {names}")
        self.axes = list(axes)

    @property
    def size(self) -> int:
        n = 1
        for a in self.axes:
            n *= len(a.values)
        return n

    def default(self) -> Candidate:
        """The axis-first-values candidate — the configuration the
        framework runs with no tuning at all.  Winners are judged
        against its MEASURED time (acceptance: winner >= default)."""
        return Candidate({a.name: a.values[0] for a in self.axes})

    def candidates(self) -> List[Candidate]:
        out = []
        for combo in itertools.product(*(a.values for a in self.axes)):
            out.append(Candidate(dict(zip((a.name for a in self.axes),
                                          combo))))
        return out

    def __repr__(self):
        return (f"SearchSpace({len(self.axes)} axes, "
                f"{self.size} candidates)")


# ---------------------------------------------------------------------------
# axis builders


def bn_conv_space(O: int = 256) -> SearchSpace:
    """Fused BatchNorm 3x3 forward space: implementation variant (v1 =
    K13, v2 = K14, reference = the unfused composition) x K14's O block
    (0 = the kernel's own rule)."""
    blocks = [0]  # 0 = kernel's own heuristic
    blocks += [b for b in (128, 256) if O % b == 0]
    return SearchSpace([
        Choice("bn_conv.variant", ("v1", "v2", "reference")),
        Choice("bn_conv.block_o", tuple(dict.fromkeys(blocks))),
    ])


def paged_space(max_ctx: int = 1024) -> SearchSpace:
    """Paged-attention space: tokens per KV page (the decode kernel's
    unit of work and the allocator's granularity)."""
    sizes = [s for s in (16, 32, 64) if s <= max_ctx]
    return SearchSpace([
        Choice("paged_attention.page_size", tuple(sizes)),
    ])


def spec_decode_space(n_layers: int = 4,
                      max_new: int = 12) -> SearchSpace:
    """Speculative-decoding serve-loop space: proposal depth
    K x draft tower depth.  K is bounded by the per-request new-token
    budget (a K >= max_new round could never accept its tail) and the
    draft must be strictly shallower than the target (equal depth is
    the target itself — all cost, no speedup).  Defaults first: K=4 and
    the half-depth draft, matching ``knobs.speculation_k`` /
    ``spec_draft_layers``."""
    ks = [k for k in (4, 2, 8, 1) if 1 <= k < max_new] or [1]
    drafts = [d for d in (max(1, n_layers // 2), 1, n_layers - 1)
              if 1 <= d < n_layers]
    drafts = list(dict.fromkeys(drafts)) or [1]
    return SearchSpace([
        Choice("spec_decode.speculation_k", tuple(ks)),
        Choice("spec_decode.draft_layers", tuple(drafts)),
    ])


def step_loop_space(ks: Sequence[int] = (1, 2, 4, 8)) -> SearchSpace:
    """Fused K-step dispatch axis (framework/step_loop.py): how many
    training steps one dispatch runs (one replay of a captured CUDA
    graph on the card).  K=1 first
    — the plain dispatch-per-step path is the default an un-tuned
    `Executor.run` takes.  The winner lands under the
    ("step_loop", {}) site that ``knobs.steps_per_dispatch`` resolves
    for callers that opt in with ``store=True``."""
    return SearchSpace([
        Choice("step_loop.steps_per_dispatch", tuple(ks)),
    ])


def mlp_depth_space(depths: Sequence[int] = (16, 4, 1)) -> SearchSpace:
    """Depth-vs-width axis at ~constant hidden FLOPs (depth * width^2
    fixed): the op-COUNT workload.  The deepest stack is the default
    (first value) on purpose — the raw roofline prices it cheapest
    (slightly fewer projection FLOPs/bytes), while the measured winner
    on a dispatch-overhead-dominated host is the shallow build, so this
    axis is rankable only by a cost layer that charges per-op overhead
    (the calibration store's affine fit)."""
    return SearchSpace([Choice("mlp.depth", tuple(depths))])


def remat_space() -> SearchSpace:
    """Generic program space (saved models, the program workloads):
    remat off/on."""
    return SearchSpace([Choice("remat", (False, True))])
