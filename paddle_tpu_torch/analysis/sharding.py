"""Static sharding-propagation & communication analyzer — the port of
``paddle_tpu/analysis/sharding.py``, rule for rule.

Three layers, all desc-only (nothing compiles or runs):

1. **Logical-axis rules** (the t5x vocabulary — SNIPPETS.md [1]-[3]):
   named logical axes on variables (`AxisNames`), ordered
   `(logical, mesh-axis)` rule pairs (`LogicalAxisRules`), and explicit
   per-var constraints, resolved by `logical_to_mesh_axes` /
   `LogicalPartitioner` into the same `{var: NamedSharding}` plan shape
   `DistributeTranspiler` produces.  Rule conflicts (one mesh axis
   claimed by two dims of a var, a constraint fighting the rules) are
   first-class results, not exceptions — they become PTV018.

2. **Propagation** (`propagate`): a forward/backward walk of the
   ProgramDesc dataflow graph that infers a per-var spec from the seed
   plan (feeds + persistables, i.e. `ParallelExecutor.static_plan`) and
   per-op rules — registered beside emitters via
   `ops.registry.register_sharding`, with structural defaults here
   (elementwise join, batch-led reshape, reductions).  The walk records
   every implicit reshard it has to insert (PTV019) and every collective
   the program implies.

3. **Communication classification** (`comm_report`): each implied
   collective (all-reduce / all-gather / reduce-scatter / all-to-all /
   collective-permute) carries the mesh axes it spans and its per-device
   buffer bytes — the same convention as the per-device HLO module
   `tools/hlo_analysis.py comm` parses, so static and actual compare
   byte-for-byte.  Wire cost prices ICI and DCN axes separately
   (`CHIP_SPECS` ici_gbps/dcn_gbps; a ``dcn`` axis-name prefix marks DCN
   axes, see parallel/mesh.py), feeding the comm-aware roofline in
   `analysis/cost.py` and the per-mode scaling-efficiency curve.

Wire time is priced from the port's chip table (``analysis/cost.py``:
``h100-sxm`` NVLink and InfiniBand rates, ``cpu-host``); ``chip=
"tpu-v5e"`` prices with the TPU v5e's ICI and DCN rates that the JAX
package's table holds, so the two packages' reports compare field for
field.  The port's ``ParallelExecutor`` runs the collectives this module
predicts through ``parallel/collectives.py`` and counts them.

The collective model is calibrated against XLA GSPMD's observed
lowering on this toolchain (validated exactly on the dp / mp / fsdp
small-LM programs, tests/test_sharding.py):

* a trainable param's gradient is produced at its NATURAL sharding (the
  spec the contraction leaves on it) and all-reduced over the batch-led
  axes, full buffer bytes at that sharding — GSPMD lowers the dp-sharded
  grad sum as all-reduce (+ slice when the param itself is dp-sharded),
  NOT reduce-scatter, so the analyzer says all-reduce too;
* an operand sharded over an axis that also shards another operand's
  batch dim (the FSDP collision) is ALL-GATHERED (full bytes, once —
  the backward re-trace CSEs with the forward);
* an operand sharded over a free contraction axis (row-parallel mp)
  leaves a partial sum: ALL-REDUCE of the op's per-device output;
* optimizer state written at a natural sharding the plan does not want
  is ALL-GATHERED back (full bytes, once per written buffer — the mp
  bias/moment gathers).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..framework.core import GRAD_SUFFIX
from . import dataflow
from .memory import bind_shape, dtype_bytes

# ---------------------------------------------------------------------------
# logical-axis vocabulary (t5x-style)


class AxisNames(tuple):
    """Tuple of logical-axis names for one variable's dims.  A distinct
    class (not a plain tuple) so rule tables and pytree-ish consumers
    can tell "names of axes" from "a sequence of things"."""

    def __new__(cls, *names):
        return tuple.__new__(AxisNames, names)

    def __repr__(self):
        return "AxisNames%s" % tuple.__repr__(self)


# ordered (logical axis, mesh axis | None[, min dim size]) entries;
# earlier rules win, later duplicates are fallbacks tried when the
# winner's mesh axis is unavailable or does not divide the dim.  The
# optional third element is a width threshold: the rule only applies to
# dims of at least that size (the ≥128 column-parallel gate — sharding
# a narrow fc over mp costs more in lane padding than it saves).  A
# mesh-axis entry may itself be a TUPLE of axis names (hybrid ICI×DCN
# meshes: ("dcn_dp", "dp") shards one dim over both link classes).
LogicalAxisRules = Sequence[tuple]

# the ≥128 column-parallel width threshold (rule family 3 of the
# partitioner collapse): last-dim mp sharding only pays for itself at
# lane width — one constant shared by the rule table, its tests, and
# the docs table
COLUMN_PARALLEL_MIN = 128


def standard_logical_axis_rules(dp_axis: str = "dp", mp_axis: str = "mp",
                                sp_axis: str = "sp",
                                zero_dp_states: bool = False,
                                fsdp_params: bool = False) -> list:
    """The default logical→mesh table: the rules the 11 bespoke modes
    collapse into (ROADMAP #2).  `None` pins a logical axis replicated.

    `state0` names dim 0 of an optimizer accumulator and `param0` dim 0
    of a non-embedding trainable param — replicated by default.  Rule
    family 1 (ZeRO-1 / FSDP dim-0 optimizer-state reshard, the
    cross-replica weight-update sharding of arXiv:2004.13336) is two
    flags inserting dp-axis rules for those names: `zero_dp_states`
    shards accumulator dim 0, `fsdp_params` additionally shards
    trainable-param dim 0 (with a `("vocab", dp)` FALLBACK so an
    embedding table dp-shards only where no mp axis claimed it).
    Indivisible dims fall through to the replicated fallbacks — the
    same `shape[0] % dp == 0` gate the bespoke wiring applied."""
    rules: list = [
        ("batch", dp_axis),
        ("length", sp_axis),
        ("vocab", mp_axis),
        ("mlp", mp_axis, COLUMN_PARALLEL_MIN),
        ("heads", mp_axis),
        ("expert", "ep"),
        ("stage", "pp"),
    ]
    if fsdp_params:
        rules += [("vocab", dp_axis), ("param0", dp_axis),
                  ("state0", dp_axis)]
    elif zero_dp_states:
        rules += [("state0", dp_axis)]
    rules += [
        ("embed", None),
        ("kv", None),
        ("state0", None),
        ("param0", None),
    ]
    return rules


def logical_to_mesh_axes(axis_names: Sequence[Optional[str]],
                         rules: LogicalAxisRules,
                         mesh_axis_sizes: Optional[Dict[str, int]] = None,
                         dim_sizes: Optional[Sequence[int]] = None,
                         conflicts: Optional[list] = None) -> tuple:
    """Resolve one variable's logical axes into a spec tuple.

    For each dim: the first rule matching its logical name whose mesh
    axis exists (size > 1) and divides the dim wins; no match (or an
    explicit `(logical, None)` rule) leaves the dim unsharded.  A rule
    may carry a third element — a minimum dim size below which it is
    skipped (the ≥128 column-parallel width gate), falling through to
    the next rule like an absent axis.  A mesh-axis entry may be a
    TUPLE of axis names (hybrid ICI×DCN meshes): the dim shards over
    their product, all components must exist and the product must
    divide the dim.  A mesh axis already claimed by an earlier dim of
    the SAME variable is a conflict (two rules forcing incompatible
    specs on one var — a tensor cannot shard two dims over one axis);
    the later dim stays unsharded and the conflict is recorded for
    PTV018."""
    spec: List[Optional[str]] = []
    used: Dict[str, str] = {}
    for d, logical in enumerate(axis_names):
        chosen = None
        if logical is not None:
            for rule in rules:
                rule_logical, mesh_axis = rule[0], rule[1]
                min_size = int(rule[2]) if len(rule) > 2 else 0
                if rule_logical != logical:
                    continue
                if min_size and dim_sizes is not None \
                        and d < len(dim_sizes) \
                        and 0 <= int(dim_sizes[d]) < min_size:
                    continue  # below the width gate: try a fallback
                if mesh_axis is None:
                    break  # explicitly replicated
                parts = entry_axes(mesh_axis)
                if mesh_axis_sizes is not None:
                    size = 1
                    for a in parts:
                        size *= int(mesh_axis_sizes.get(a, 1))
                    if size <= 1 or any(
                            int(mesh_axis_sizes.get(a, 1)) <= 1
                            for a in parts):
                        continue  # axis absent: try a fallback rule
                    if dim_sizes is not None and d < len(dim_sizes) \
                            and int(dim_sizes[d]) >= 0 \
                            and int(dim_sizes[d]) % size != 0:
                        continue  # indivisible: try a fallback rule
                        # (-1 batch markers are feed-time dims the
                        # caller promises to keep divisible)
                clash = next((a for a in parts if a in used), None)
                if clash is not None:
                    if conflicts is not None:
                        conflicts.append((logical, clash, used[clash]))
                    break
                chosen = mesh_axis
                for a in parts:
                    used[a] = logical
                break
        spec.append(chosen)
    return tuple(spec)


class LogicalPartitioner:
    """Rules + per-var logical-axis declarations + explicit constraints
    → a `{var: NamedSharding}` plan, the same shape the transpiler
    produces, but derived from NAMED axes instead of per-mode wiring.

    `axis_names` maps var name → AxisNames; undeclared vars fall back to
    `infer_logical_axes` (feeds are batch-led, embedding tables are
    (vocab, embed), 2-D weights (embed, mlp) — the transpiler heuristics
    re-expressed as logical names).  `constraints` maps var name → an
    explicit spec tuple that OVERRIDES the rules; a constraint that
    disagrees with a non-trivial rule-derived spec is recorded as a
    conflict (PTV018) rather than silently winning."""

    def __init__(self, rules: Optional[LogicalAxisRules] = None,
                 axis_names: Optional[Dict[str, AxisNames]] = None,
                 constraints: Optional[Dict[str, tuple]] = None):
        self.rules = list(rules if rules is not None
                          else standard_logical_axis_rules())
        self.axis_names = dict(axis_names or {})
        self.constraints = {k: tuple(v) for k, v in
                            (constraints or {}).items()}
        self.conflicts: List[dict] = []

    # -- logical-name inference (the transpiler heuristics, named) -----
    def infer_logical_axes(self, var, embedding_names=()) -> AxisNames:
        shape = var.shape or ()
        ndim = len(shape)
        if var.is_data:
            if ndim == 0:
                return AxisNames()
            if ndim >= 3:
                return AxisNames("batch", "length",
                                 *(["embed"] * (ndim - 2)))
            return AxisNames("batch", *([None] * (ndim - 1)))
        if var.name in embedding_names and ndim >= 2:
            return AxisNames("vocab", *(["embed"] * (ndim - 1)))
        if getattr(var, "accumulator_for", None):
            # optimizer accumulator (positively tagged by
            # Optimizer._add_accumulator): dim 0 is the ZeRO-1 shard
            # target — replicated under the standard table, dp-sharded
            # when `zero_dp_states`/`fsdp_params` insert a state0 rule
            if ndim == 0:
                return AxisNames()
            tail = ["mlp"] if ndim == 2 else [None] * (ndim - 1)
            return AxisNames("state0", *tail)
        trainable = getattr(var, "trainable", False)
        if ndim == 2:
            return AxisNames("param0" if trainable else "embed", "mlp")
        if trainable and ndim >= 1:
            # conv filters, biases, BN scale/shift: dim 0 is the FSDP
            # shard target (param0 → dp only when an fsdp rule exists)
            return AxisNames("param0", *([None] * (ndim - 1)))
        return AxisNames(*([None] * ndim))

    def plan(self, program, mesh,
             provenance: Optional[Dict[str, str]] = None
             ) -> Dict[str, object]:
        """{var: NamedSharding} over `mesh` for every persistable and
        feed var; records conflicts (never raises on them).  Pass
        `provenance={}` to collect {var: which rule produced the spec}
        — the strings `ParallelExecutor.static_plan` forwards into
        PTV016 findings (kept in the shapes the pre-collapse bespoke
        wiring minted, so existing triage docs stay accurate)."""
        from ..parallel.mesh import mesh_axis_sizes, named

        sizes = mesh_axis_sizes(mesh)
        block = program.global_block()
        embedding_names = set()
        for op in block.ops:
            if op.type == "lookup_table":
                embedding_names.update(op.input("W"))
        out: Dict[str, object] = {}
        for var in block.vars.values():
            if not (var.persistable or var.is_data):
                continue
            names = self.axis_names.get(
                var.name, self.infer_logical_axes(var, embedding_names))
            raw: List[tuple] = []
            spec = logical_to_mesh_axes(
                names, self.rules, sizes, tuple(var.shape or ()),
                conflicts=raw)
            for logical, axis, holder in raw:
                self.conflicts.append({
                    "var": var.name, "logical": logical,
                    "mesh_axis": axis,
                    "reason": f"rule ({logical!r} -> {axis!r}) and rule "
                              f"({holder!r} -> {axis!r}) both claim mesh "
                              f"axis {axis!r} on {var.name!r}"})
            if var.name in self.constraints:
                want = self.constraints[var.name]
                if any(e for e in spec) and tuple(spec) != tuple(want):
                    self.conflicts.append({
                        "var": var.name, "logical": None,
                        "mesh_axis": None,
                        "reason": f"explicit constraint {want!r} "
                                  f"contradicts rule-derived spec "
                                  f"{tuple(spec)!r} on {var.name!r}"})
                spec = tuple(want)
            out[var.name] = named(mesh, *spec)
            if provenance is not None and any(e for e in spec):
                provenance[var.name] = describe_rule(var, names, spec,
                                                     sizes)
        return out


def describe_rule(var, names: AxisNames, spec: tuple,
                  axis_sizes: Dict[str, int]) -> str:
    """Human name of the logical rule that produced `spec` for `var`."""
    def prod(entry) -> int:
        n = 1
        for a in entry_axes(entry):
            n *= int(axis_sizes.get(a, 1))
        return n

    if getattr(var, "is_data", False):
        parts = []
        if spec and spec[0] is not None:
            parts.append(f"feed batch rule ({spec[0]!r} on dim 0)")
        if len(spec) > 1 and spec[1] is not None:
            parts.append(f"length rule ({spec[1]!r} on dim 1)")
        return " + ".join(parts) or "feed rule"
    lead = names[0] if names else None
    if spec and spec[0] is not None:
        if lead == "state0":
            return (f"ZeRO-1 accumulator reshard over {spec[0]!r} on "
                    f"dim 0 (axis size {prod(spec[0])})")
        if lead == "param0":
            return (f"FSDP/ZeRO-3 parameter shard over {spec[0]!r} on "
                    f"dim 0 (axis size {prod(spec[0])})")
        return f"vocab/dim-0 shard rule ({spec[0]!r} on dim 0)"
    if spec and spec[-1] is not None:
        return f"column-parallel rule ({spec[-1]!r} on the last dim)"
    return "axis rule"


# ---------------------------------------------------------------------------
# spec plumbing


def spec_of(sharding, ndim: Optional[int] = None) -> tuple:
    """Positional spec tuple from a NamedSharding / PartitionSpec /
    tuple, padded with None to `ndim` when given."""
    if sharding is None:
        entries: tuple = ()
    else:
        spec = getattr(sharding, "spec", sharding)
        try:
            entries = tuple(spec)
        except TypeError:
            entries = ()
    out = []
    for e in entries:
        if isinstance(e, (tuple, list)):
            e = tuple(a for a in e if a) or None
            if e is not None and len(e) == 1:
                e = e[0]
        out.append(e if e else None)
    if ndim is not None:
        out = (out + [None] * ndim)[:ndim]
    return tuple(out)


def entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def spec_axes(spec) -> tuple:
    """Flat mesh-axis names a spec shards over, in dim order."""
    out = []
    for e in spec or ():
        out.extend(entry_axes(e))
    return tuple(out)


def spec_divisor(spec, axis_sizes: Dict[str, int]) -> int:
    d = 1
    for a in spec_axes(spec):
        d *= int(axis_sizes.get(a, 1))
    return max(d, 1)


# ---------------------------------------------------------------------------
# analysis records


@dataclass
class Collective:
    """One implied collective.  `bytes` is the PER-DEVICE buffer size of
    the collective's output — the convention of the per-device SPMD HLO
    module, so `tools/hlo_analysis.py comm` compares directly.  `axes`
    are the mesh axes it spans; `scales_with_axes` marks byte counts
    that shrink as the spanned axis grows (batch-led buffers) for the
    scaling-curve projection."""

    kind: str                   # all-reduce | all-gather | reduce-scatter
                                # | all-to-all | collective-permute
    axes: tuple                 # mesh axes spanned
    bytes: int                  # per-device buffer bytes
    var: Optional[str] = None
    op: Optional[int] = None
    phase: str = "fwd"          # fwd | bwd | update | loss | p2p
    why: str = ""
    scales_with_axes: bool = False


@dataclass
class Reshard:
    """An implicit reshard the propagation had to insert at an op
    boundary: operand `var` arrives as `src` but op `op` consumes it as
    `dst`.  `hot` marks per-step cost (a transient, or inside a nested
    loop block) — the PTV019 domain."""

    var: str
    op: int
    src: tuple
    dst: tuple
    bytes: int
    hot: bool


@dataclass
class ShardingAnalysis:
    specs: Dict[str, tuple] = field(default_factory=dict)
    collectives: List[Collective] = field(default_factory=list)
    reshards: List[Reshard] = field(default_factory=list)
    conflicts: List[dict] = field(default_factory=list)
    axis_sizes: Dict[str, int] = field(default_factory=dict)
    provenance: Dict[str, str] = field(default_factory=dict)
    batch_size: int = 0

    def per_kind(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for c in self.collectives:
            e = out.setdefault(c.kind, {"count": 0, "bytes": 0})
            e["count"] += 1
            e["bytes"] += c.bytes
        return out


# ---------------------------------------------------------------------------
# the propagation engine


class PropagationContext:
    """What a sharding rule sees: mesh axis sizes, operand views, the
    collective sink, and the shared matmul/byte helpers.  Handed to
    rules registered with `ops.registry.register_sharding`."""

    def __init__(self, prop: "_Propagator", op_index: int, phase: str):
        self._prop = prop
        self.analysis = prop.analysis
        self.op_index = op_index
        self.phase = phase

    def device_bytes(self, name: str, spec) -> int:
        """Per-device bytes of var `name` under `spec`."""
        return self._prop._device_bytes(name, spec)

    def global_bytes(self, name: str) -> int:
        return self._prop._global_bytes(name)

    def matmul(self, x: "ShardedOperand", w: "ShardedOperand",
               out_name: str, w_contract_dim: int = 0) -> tuple:
        """The calibrated X @ W propagation (collision-gather /
        partial-sum all-reduce); returns (lead, n) spec entries."""
        return self._prop.matmul_forward(self, x, w, out_name,
                                         w_contract_dim)

    def axis_size(self, name: str) -> int:
        return int(self.analysis.axis_sizes.get(name, 1))

    def collective(self, kind: str, axes, bytes_: int, var=None,
                   why: str = "", phase: Optional[str] = None,
                   scales_with_axes: bool = False):
        axes = tuple(a for a in (axes if isinstance(axes, (tuple, list))
                                 else (axes,)) if a)
        if not axes:
            return
        if self.analysis.axis_sizes \
                and all(self.axis_size(a) <= 1 for a in axes):
            return  # size-1 axes: no communication.  With NO mesh at
            # all (a bare-PartitionSpec plan) sizes are unknown — keep
            # the collective so PTV021 and the breakdown stay armed
        self.analysis.collectives.append(Collective(
            kind=kind, axes=axes, bytes=int(bytes_), var=var,
            op=self.op_index, phase=phase or self.phase, why=why,
            scales_with_axes=scales_with_axes))


@dataclass
class ShardedOperand:
    """One operand as a sharding rule sees it."""

    name: str
    spec: tuple
    shape: tuple                # global shape, batch bound
    itemsize: int

    @property
    def global_bytes(self) -> int:
        n = 1
        for s in self.shape:
            n *= max(int(s), 1)
        return n * self.itemsize

    def device_bytes(self, axis_sizes) -> int:
        return self.global_bytes // spec_divisor(self.spec, axis_sizes)


_OPTIMIZER_SLOTS = ("Param", "Grad")

_FREE_TYPES = ("feed", "fetch", "shape", "lod_reset", "print", "save")

# attr names a transpose op may carry its permutation under
_PERMUTE_ATTRS = ("perm", "axis", "order")


class _Propagator:
    def __init__(self, program, mesh=None, plan=None, batch_size=64,
                 block_id=0, provenance=None, infer_shapes=True):
        self.program = program
        self.block = program.blocks[block_id]
        self.block_id = block_id
        self.plan = dict(plan or {})
        # the PTV006 abstract-eval oracle fills in helper vars with no
        # declared shape (the attention reshape/transpose chain): a
        # shapeless var would otherwise drop its spec and break the
        # whole downstream propagation
        self._inferred: Dict[str, tuple] = {}
        if infer_shapes:
            from .memory import abstract_sizes

            try:
                self._inferred = abstract_sizes(program, block_id,
                                                batch_size)
            except Exception:
                self._inferred = {}
        if mesh is None:
            for sh in self.plan.values():
                mesh = getattr(sh, "mesh", None)
                if mesh is not None:
                    break
        self.mesh = mesh
        axis_sizes: Dict[str, int] = {}
        if mesh is not None:
            from ..parallel.mesh import mesh_axis_sizes

            axis_sizes = mesh_axis_sizes(mesh)
        self.analysis = ShardingAnalysis(
            axis_sizes=axis_sizes, batch_size=batch_size,
            provenance=dict(provenance or {}))
        self.batch_size = batch_size
        # natural (pre-plan) sharding of each param's gradient — the
        # sharding the optimizer update runs at (GSPMD propagates the
        # grad's sharding through the elementwise update)
        self._grad_natural: Dict[str, tuple] = {}
        self._def_use = None  # lazy, shared by the pipeline_stage cuts
        self._seed()

    # -- seeding -------------------------------------------------------
    def _var(self, name):
        return self.block._find_var_recursive(name) if name else None

    def _shape(self, name) -> tuple:
        v = self._var(name)
        if v is None or v.shape is None:
            got = self._inferred.get(name)
            return tuple(got[0]) if got else ()
        return bind_shape(v.shape, self.batch_size)

    def _itemsize(self, name) -> int:
        v = self._var(name)
        if v is None or v.dtype is None:
            got = self._inferred.get(name)
            if got:
                return int(got[1])
        return dtype_bytes(v.dtype if v is not None else "float32")

    def _global_bytes(self, name) -> int:
        n = 1
        for s in self._shape(name):
            n *= max(int(s), 1)
        return n * self._itemsize(name)

    def _device_bytes(self, name, spec) -> int:
        return self._global_bytes(name) // spec_divisor(
            spec, self.analysis.axis_sizes)

    def _seed(self):
        specs = self.analysis.specs
        for name, sharding in self.plan.items():
            ndim = len(self._shape(name)) or None
            spec = spec_of(sharding, ndim)
            specs[name] = spec
            # intra-var conflict: one mesh axis claimed by two dims —
            # no device assignment satisfies it (PTV018)
            seen: Dict[str, int] = {}
            for d, e in enumerate(spec):
                for a in entry_axes(e):
                    if a in seen:
                        self.analysis.conflicts.append({
                            "var": name, "logical": None, "mesh_axis": a,
                            "reason": f"plan shards dims {seen[a]} and "
                                      f"{d} of {name!r} over the same "
                                      f"mesh axis {a!r}"})
                    else:
                        seen[a] = d

    def spec(self, name) -> tuple:
        s = self.analysis.specs.get(name)
        if s is not None:
            return s
        ndim = len(self._shape(name))
        return tuple([None] * ndim)

    def operand(self, name) -> ShardedOperand:
        return ShardedOperand(name, self.spec(name), self._shape(name),
                              self._itemsize(name))

    def _set(self, name, spec):
        if name:
            self.analysis.specs[name] = tuple(spec)

    # -- main walk -----------------------------------------------------
    def run(self) -> ShardingAnalysis:
        from ..ops.registry import get_op_info, has_op

        for i, op in enumerate(self.block.ops):
            if op.type in _FREE_TYPES:
                continue
            ctx = PropagationContext(self, i, "fwd")
            ins = {slot: [self.operand(n) if n else None for n in names]
                   for slot, names in op.inputs.items()}
            outs = {slot: [self.operand(n) if n else None for n in names]
                    for slot, names in op.outputs.items()}
            handler = None
            if has_op(op.type):
                handler = get_op_info(op.type).sharding
            if op.type == "generic_grad":
                result = self._h_generic_grad(ctx, op, ins, outs)
            elif handler is not None:
                result = handler(ctx, ins, outs, op.attrs) or {}
            elif self._is_optimizer(op):
                result = self._h_optimizer(ctx, op, ins, outs)
            else:
                result = self._builtin(ctx, op, ins, outs)
            for slot, names in op.outputs.items():
                specs = (result or {}).get(slot)
                for k, n in enumerate(names):
                    if not n:
                        continue
                    if specs is not None and k < len(specs) \
                            and specs[k] is not None:
                        self._set(n, spec_of(specs[k],
                                             len(self._shape(n))))
                    elif n not in self.analysis.specs:
                        self._set(n, self._default_out_spec(n, ins))
        return self.analysis

    # -- structural defaults -------------------------------------------
    @staticmethod
    def _is_optimizer(op) -> bool:
        return all(s in op.inputs for s in _OPTIMIZER_SLOTS) \
            and "ParamOut" in op.outputs

    def _join(self, ctx, op, operands, out_name, emit=True):
        """Elementwise join of same-shape operands; disagreement =
        implicit reshard of the minority operand to the joined spec.
        `emit=False` suppresses the communication side effects (used for
        an op's secondary outputs so per-op collectives are not
        double-counted)."""
        out_shape = self._shape(out_name)
        ndim = len(out_shape)
        joined: List[object] = [None] * ndim
        contributors = [o for o in operands
                        if o is not None and len(o.shape) == ndim
                        and o.shape == out_shape]
        for o in contributors:
            for d, e in enumerate(o.spec):
                if e is None:
                    continue
                if joined[d] is None:
                    joined[d] = e
        # second pass: anyone who disagrees gets resharded (gathered)
        for o in contributors:
            mism = [d for d, e in enumerate(o.spec)
                    if e is not None and joined[d] != e]
            if mism and emit:
                v = self._var(o.name)
                hot = v is None or not (v.persistable or v.is_data)
                self.analysis.reshards.append(Reshard(
                    var=o.name, op=ctx.op_index, src=o.spec,
                    dst=tuple(joined), bytes=o.global_bytes, hot=hot))
                ctx.collective("all-gather", spec_axes(o.spec),
                               o.global_bytes, var=o.name,
                               why="implicit reshard at op boundary")
        if not contributors and ndim >= 1:
            # batch-led fallback FIRST (before the broadcast pass, so
            # `taken` knows the lead axis): a leading-dim match inherits
            # the producer's leading entry — conv's Input→Output,
            # reshape-through-batch, broadcast cases
            for o in operands:
                if o is not None and o.spec and o.spec[0] is not None \
                        and o.shape and out_shape \
                        and o.shape[0] == out_shape[0] \
                        and not (self._var(o.name) is not None
                                 and self._var(o.name).persistable):
                    joined[0] = o.spec[0]
                    break
        # broadcast operands (smaller rank/shape — biases, scales, conv
        # filters, the sliced position table): one sharded over an axis
        # the joined output already uses elsewhere cannot stay sharded —
        # GSPMD gathers it (the FSDP bias/scale/filter gathers); a FREE
        # axis instead rides onto the aligned trailing dim of the output
        taken = {a for e in joined for a in entry_axes(e)}
        for o in operands:
            if o is None or o in contributors or not spec_axes(o.spec) \
                    or (o.shape == out_shape
                        and len(o.shape) == ndim):
                continue
            v = self._var(o.name)
            offset = ndim - len(o.spec)
            for d, e in enumerate(o.spec):
                axes = entry_axes(e)
                if not axes:
                    continue
                if set(axes) & taken or offset < 0:
                    if emit and v is not None and (v.persistable
                                                  or v.is_data):
                        ctx.collective(
                            "all-gather", axes, o.global_bytes,
                            var=o.name,
                            why="broadcast operand sharded over an "
                                "axis the output already uses is "
                                "gathered for compute")
                elif joined[offset + d] is None:
                    joined[offset + d] = e
                    taken.update(axes)
        return tuple(joined)

    def _default_out_spec(self, out_name, ins):
        flat = [o for vals in ins.values() for o in vals if o is not None]
        out_shape = self._shape(out_name)
        ndim = len(out_shape)
        joined: List[object] = [None] * ndim
        for o in flat:
            if len(o.shape) == ndim and o.shape == out_shape:
                for d, e in enumerate(o.spec):
                    if e is not None and joined[d] is None:
                        joined[d] = e
        if not any(joined) and ndim >= 1:
            for o in flat:
                if o.spec and o.spec[0] is not None and o.shape \
                        and out_shape and o.shape[0] == out_shape[0]:
                    joined[0] = o.spec[0]
                    break
        return tuple(joined)

    def _builtin(self, ctx, op, ins, outs):
        t = op.type
        if t in ("reshape", "squeeze", "unsqueeze", "flatten"):
            return self._h_reshape(ctx, op, ins, outs)
        if t == "transpose":
            return self._h_transpose(ctx, op, ins, outs)
        if t in ("mean",) or t.startswith("reduce_"):
            return self._h_reduce(ctx, op, ins, outs)
        if t in ("fill_constant", "uniform_random", "gaussian_random",
                 "fill_constant_batch_size_like"):
            return {}
        if t == "pipeline_stage":
            return self._h_pipeline_stage(ctx, op, ins, outs)
        # generic: elementwise join per output — communication is
        # emitted only for the LARGEST output (layer_norm's saved
        # mean/var must not re-bill the scale/bias gathers)
        result = {}
        flat = [o for vals in ins.values() for o in vals if o is not None]
        out_names = [n for names in op.outputs.values() for n in names
                     if n]
        primary = max(out_names, key=self._global_bytes, default=None)
        for slot, names in op.outputs.items():
            specs = []
            for n in names:
                specs.append(self._join(ctx, op, flat, n,
                                        emit=(n == primary))
                             if n else None)
            result[slot] = specs
        return result

    def _h_reshape(self, ctx, op, ins, outs):
        src = next((o for vals in ins.values() for o in vals
                    if o is not None and o.spec), None)
        result = {}
        for slot, names in op.outputs.items():
            specs = []
            for n in names:
                if not n:
                    specs.append(None)
                    continue
                out_shape = self._shape(n)
                spec: List[object] = [None] * len(out_shape)
                if src is not None and src.spec and out_shape:
                    lead = src.spec[0]
                    if lead is not None and src.shape:
                        # the leading (batch) entry survives any reshape
                        # that keeps or merges the leading dim (B,T,D ->
                        # B*T,D and B,T,D -> B,T*D alike): the rows
                        # stay batch-major
                        spec[0] = lead
                    # a trailing sharded entry survives when the last
                    # dim is unchanged
                    if len(src.spec) >= 1 and src.spec[-1] is not None \
                            and out_shape and src.shape \
                            and out_shape[-1] == src.shape[-1] \
                            and len(out_shape) > 1:
                        spec[-1] = src.spec[-1]
                specs.append(tuple(spec))
            result[slot] = specs
        return result

    def _h_transpose(self, ctx, op, ins, outs):
        src = next((o for vals in ins.values() for o in vals
                    if o is not None), None)
        perm = None
        for key in _PERMUTE_ATTRS:
            if key in op.attrs and isinstance(op.attrs[key],
                                              (list, tuple)):
                perm = list(op.attrs[key])
                break
        result = {}
        for slot, names in op.outputs.items():
            specs = []
            for n in names:
                if not n or src is None:
                    specs.append(None)
                    continue
                if perm is not None and len(perm) == len(src.spec):
                    specs.append(tuple(src.spec[p] for p in perm))
                else:
                    specs.append(tuple(reversed(src.spec)))
            result[slot] = specs
        return result

    def _h_reduce(self, ctx, op, ins, outs):
        """Full or axis reduction: reduced sharded axes leave partial
        sums — all-reduce of the per-device output."""
        src = next((o for vals in ins.values() for o in vals
                    if o is not None), None)
        result = {}
        for slot, names in op.outputs.items():
            specs = []
            for n in names:
                if not n or src is None:
                    specs.append(None)
                    continue
                out_shape = self._shape(n)
                # which input dims survive? match trailing shapes;
                # full reduce when output is scalar/1-elem
                reduced_axes = []
                out_spec: List[object] = [None] * len(out_shape)
                out_elems = 1
                for s in out_shape:
                    out_elems *= max(int(s), 1)
                if out_elems == 1:
                    reduced_axes = list(spec_axes(src.spec))
                else:
                    dim = op.attrs.get("dim")
                    dims = ([dim] if isinstance(dim, int)
                            else list(dim or ()))
                    kept = [d for d in range(len(src.spec))
                            if d not in [x % max(len(src.shape), 1)
                                         for x in dims]]
                    for j, d in enumerate(kept[:len(out_spec)]):
                        out_spec[j] = src.spec[d]
                    for d in range(len(src.spec)):
                        if d not in kept:
                            reduced_axes.extend(entry_axes(src.spec[d]))
                if reduced_axes:
                    bytes_ = self._device_bytes(n, tuple(out_spec))
                    ctx.collective(
                        "all-reduce", tuple(reduced_axes), bytes_,
                        var=n, phase="loss" if out_elems == 1 else "fwd",
                        why=f"{op.type} over sharded dims",
                        scales_with_axes=False)
                specs.append(tuple(out_spec))
            result[slot] = specs
        return result

    def _h_pipeline_stage(self, ctx, op, ins, outs):
        """Stage boundary: everything live across the marker crosses a
        pp link, forward activations and backward cotangents both."""
        pp = ctx.axis_size("pp")
        if pp <= 1:
            return {}
        i = ctx.op_index
        if self._def_use is None:
            self._def_use = dataflow.def_use(self.block)
        defs, uses = self._def_use
        cut = 0
        for name, dlist in defs.items():
            v = self._var(name)
            if v is None or v.persistable or v.is_data:
                continue
            if name.endswith(GRAD_SUFFIX):
                continue
            if dlist[0] < i and any(u > i for u in uses.get(name, [])):
                cut += self._device_bytes(name, self.spec(name))
        if cut:
            ctx.collective("collective-permute", ("pp",), cut,
                           phase="p2p",
                           why="stage-boundary activations (per "
                               "microbatch)", scales_with_axes=True)
            ctx.collective("collective-permute", ("pp",), cut,
                           phase="p2p",
                           why="stage-boundary cotangents (per "
                               "microbatch)", scales_with_axes=True)
        return {}

    # -- matmul-family helpers (shared with registered rules) ----------
    def matmul_forward(self, ctx, x: ShardedOperand, w: ShardedOperand,
                      out_name: str, w_contract_dim: int = 0):
        """Propagate X @ W (X rows batch-led, W 2-D): returns out spec.
        Implements the calibrated GSPMD decisions: axis collision on
        the contraction → all-gather the param; free contraction axis →
        all-reduce the per-device output."""
        sizes = ctx.analysis.axis_sizes
        x_lead = x.spec[0] if x.spec else None
        x_contract = x.spec[-1] if x.spec else None
        w_spec = list(w.spec) if len(w.spec) == 2 else [None, None]
        w_k = w_spec[w_contract_dim]
        w_n = w_spec[1 - w_contract_dim]
        out_spec = [x_lead, w_n]
        batch_axes = set(entry_axes(x_lead))
        # one event per contraction AXIS, however many operands carry it
        # (row-parallel shards K on BOTH sides yet pays one all-reduce)
        gathered = set()
        reduced = set()
        for a in entry_axes(w_k):
            if int(sizes.get(a, 1)) > 1 and a in batch_axes:
                gathered.add(a)  # FSDP collision: gather the param
        for src in (x_contract, w_k):
            for a in entry_axes(src):
                if int(sizes.get(a, 1)) <= 1 or a in gathered \
                        or a in batch_axes:
                    continue
                reduced.add(a)
        for a in sorted(gathered):
            ctx.collective(
                "all-gather", (a,), w.global_bytes, var=w.name,
                why="param sharded over the batch axis is gathered "
                    "for compute")
        for a in sorted(reduced):
            ctx.collective(
                "all-reduce", (a,),
                self._device_bytes(out_name, tuple(out_spec)),
                var=out_name,
                why="partial sums over sharded contraction dim",
                scales_with_axes=True)
        return tuple(out_spec)

    def param_grad(self, ctx, pname: str, natural: tuple,
                   reduce_axes: Iterable[str], why: str):
        """Common param-gradient path: all-reduce over the batch-led
        `reduce_axes` at the grad's NATURAL sharding; remembers the
        natural spec for the optimizer-update gather stage."""
        natural = tuple(natural)
        self._grad_natural[pname] = natural
        axes = tuple(a for a in reduce_axes
                     if int(ctx.analysis.axis_sizes.get(a, 1)) > 1
                     and a not in spec_axes(natural))
        if axes:
            ctx.collective(
                "all-reduce", axes,
                self._device_bytes(pname, natural),
                var=pname + GRAD_SUFFIX, phase="bwd", why=why)
        return natural

    # -- generic_grad --------------------------------------------------
    def _h_generic_grad(self, ctx, op, ins, outs):
        ctx.phase = "bwd"
        fwd_type = op.attrs.get("__fwd_type__", "")
        in_slots = tuple(op.attrs.get("__fwd_input_slots__", ()))
        out_slots = tuple(op.attrs.get("__fwd_output_slots__", ()))

        # shard_map-explicit ops (ring/ulysses attention, moe dispatch)
        # genuinely RE-PAY their collectives in the vjp re-trace — no
        # CSE across the custom_vjp boundary; their registered rules
        # mark themselves bwd_retrace and are re-run here
        from ..ops.registry import get_op_info, has_op

        if has_op(fwd_type):
            rule = get_op_info(fwd_type).sharding
            if rule is not None and getattr(rule, "bwd_retrace", False):
                fwd_ins = {s: [self.operand(n) if n else None
                               for n in op.input(s)] for s in in_slots}
                fwd_outs = {s: [self.operand(n) if n else None
                                for n in op.input(s)]
                            for s in out_slots}
                rule(ctx, fwd_ins, fwd_outs,
                     op.attrs.get("__fwd_attrs__", {}))

        # batch-led reduce axes: leading-entry axes of the op's
        # TRANSIENT operands and cotangents (what a param grad sums over)
        reduce_axes: List[str] = []
        for slot in in_slots + tuple(s + GRAD_SUFFIX for s in out_slots):
            for n in op.input(slot):
                if not n:
                    continue
                v = self._var(n)
                if v is not None and v.persistable:
                    continue
                sp = self.spec(n)
                for a in entry_axes(sp[0] if sp else None):
                    if a not in reduce_axes:
                        reduce_axes.append(a)

        result: Dict[str, list] = {}
        for slot, names in op.outputs.items():
            base_slot = slot[:-len(GRAD_SUFFIX)] \
                if slot.endswith(GRAD_SUFFIX) else slot
            fwd_names = op.input(base_slot)
            specs = []
            for k, gname in enumerate(names):
                if not gname:
                    specs.append(None)
                    continue
                xname = fwd_names[k] if k < len(fwd_names) else None
                xvar = self._var(xname) if xname else None
                if xvar is not None and xvar.persistable:
                    natural = self._param_grad_natural(
                        ctx, op, fwd_type, base_slot, xname,
                        reduce_axes)
                    specs.append(self.param_grad(
                        ctx, xname, natural, reduce_axes,
                        why=f"{fwd_type} parameter gradient"))
                else:
                    specs.append(self._transient_grad(
                        ctx, op, fwd_type, xname, gname))
            result[slot] = specs
        return result

    def _param_grad_natural(self, ctx, op, fwd_type, slot, pname,
                            reduce_axes=()):
        """The sharding the contraction leaves on a param's gradient —
        NOT the param's planned spec: a replicated bias fed by an
        mp-sharded activation gets an mp-sharded grad (and the update
        then runs sharded; the gather back to the plan is priced by the
        optimizer stage), and an FSDP param sharded over the BATCH axis
        gets a FULL (replicated) grad — GSPMD all-reduces it whole and
        slices afterward."""
        p = self.operand(pname)
        ndim = len(p.shape)
        if fwd_type in ("mul", "matmul") and slot in ("Y", "X") \
                and ndim == 2:
            # dW = X^T @ dOut: dims inherit (X contraction entry,
            # cotangent last entry); the batch collision (FSDP) leaves
            # the grad replicated on that dim
            others = [self.operand(n)
                      for s in ("X", "Y") if s != slot
                      for n in op.input(s) if n]
            x = others[0] if others else None
            ct = None
            for s in op.inputs:
                if s.endswith(GRAD_SUFFIX) and op.input(s) \
                        and op.input(s)[0]:
                    ct = self.operand(op.input(s)[0])
                    break
            batch = set(entry_axes(x.spec[0])) if x is not None \
                and x.spec else set()
            k_entry = x.spec[-1] if x is not None and x.spec else None
            n_entry = ct.spec[-1] if ct is not None and ct.spec else None
            k_entry = None if set(entry_axes(k_entry)) & batch else k_entry
            n_entry = None if set(entry_axes(n_entry)) & batch else n_entry
            if slot == "Y":
                return (k_entry, n_entry)
            return (n_entry, k_entry)
        if fwd_type == "lookup_table" and ndim >= 2:
            # scatter-add grad inherits the table's vocab shard unless
            # the collision forced a gather (then it is replicated)
            ids = next((self.operand(n) for n in op.input("Ids") if n),
                       None)
            batch = set(entry_axes(ids.spec[0])) if ids is not None \
                and ids.spec else set()
            vocab = p.spec[0] if p.spec else None
            if set(entry_axes(vocab)) & batch:
                vocab = None
            return (vocab,) + tuple(p.spec[1:])
        if ndim == 1:
            # bias / scale: grad = reduce of the cotangent over its
            # leading dims; inherits the cotangent's LAST entry
            for s in op.inputs:
                if s.endswith(GRAD_SUFFIX):
                    names = op.input(s)
                    if names and names[0]:
                        ct = self.operand(names[0])
                        if ct.spec:
                            return (ct.spec[-1],)
            return (None,)
        # default: the planned spec with batch-colliding axes dropped
        # (FSDP conv filters: the batch contraction can't preserve a
        # shard over the batch axis — the grad comes out full)
        reduce_set = set(reduce_axes)
        out = []
        for e in self.spec(pname):
            axes = tuple(a for a in entry_axes(e) if a not in reduce_set)
            out.append(axes[0] if len(axes) == 1
                       else (axes if axes else None))
        return tuple(out)

    def _transient_grad(self, ctx, op, fwd_type, xname, gname):
        """An activation's gradient follows the activation; matmul dX
        additionally pays a partial-sum all-reduce when the contraction
        runs over an axis x itself does not carry (row-parallel
        backward), and a BROADCAST operand's grad is a reduction over
        the broadcast dims — sharded broadcast dims leave partial sums
        (the position-table grad)."""
        spec = self.spec(xname) if xname else tuple(
            [None] * len(self._shape(gname)))
        if xname:
            # broadcast reduce: x has fewer dims than its cotangent
            ct = None
            for s in op.inputs:
                if s.endswith(GRAD_SUFFIX) and op.input(s) \
                        and op.input(s)[0]:
                    ct = self.operand(op.input(s)[0])
                    break
            if ct is not None and len(ct.spec) > len(spec):
                lead = ct.spec[:len(ct.spec) - len(spec)]
                axes = tuple(a for e in lead for a in entry_axes(e)
                             if a not in spec_axes(spec))
                if axes:
                    ctx.collective(
                        "all-reduce", axes,
                        self._device_bytes(gname, spec), var=gname,
                        why="broadcast-operand gradient summed over "
                            "sharded broadcast dims")
        if fwd_type in ("mul", "matmul") and xname:
            w = next((self.operand(n) for n in op.input("Y") if n), None)
            if w is not None and len(w.spec) == 2:
                n_entry = w.spec[-1]
                x_axes = set(spec_axes(spec))
                for a in entry_axes(n_entry):
                    if int(ctx.analysis.axis_sizes.get(a, 1)) > 1 \
                            and a not in x_axes:
                        ctx.collective(
                            "all-reduce", (a,),
                            self._device_bytes(gname, spec), var=gname,
                            why="dX partial sums over the sharded "
                                "output dim", scales_with_axes=True)
        return spec

    # -- optimizer updates ---------------------------------------------
    def _h_optimizer(self, ctx, op, ins, outs):
        ctx.phase = "update"
        pname = op.input("Param")[0]
        gname = op.input("Grad")[0] if op.input("Grad") else None
        natural = tuple(self._grad_natural.get(
            pname, self.analysis.specs.get(gname, ()) if gname else ()))
        # the update runs at the JOIN of the grad's natural sharding and
        # the input state buffers' planned shardings: a ZeRO-1 sharded
        # velocity makes the whole Momentum update (param included) run
        # sharded, which is what forces the post-update param all-gather
        pndim = len(self._shape(pname))
        joined: List[object] = list(natural) + [None] * (
            pndim - len(natural))
        for slot, names in op.inputs.items():
            if slot in ("Param", "Grad", "LearningRate"):
                continue
            for n in names:
                if not n:
                    continue
                sp = self.spec(n)
                if len(sp) != pndim:
                    continue
                for d, e in enumerate(sp):
                    if e is not None and joined[d] is None:
                        joined[d] = e
        natural = tuple(joined[:pndim])
        result = {}
        for slot, names in op.outputs.items():
            specs = []
            for n in names:
                if not n:
                    specs.append(None)
                    continue
                planned = self.spec(n) if n in self.analysis.specs \
                    else self.spec(pname if slot == "ParamOut" else n)
                planned_axes = set(spec_axes(planned))
                extra = [a for a in spec_axes(natural)
                         if a not in planned_axes]
                if extra:
                    # the update ran at the grad's natural sharding but
                    # the plan wants this buffer differently: gather it
                    # back (full bytes — the mp bias/moment gathers)
                    ctx.collective(
                        "all-gather", tuple(extra),
                        self._global_bytes(n), var=n,
                        why="optimizer state written at the gradient's "
                            "natural sharding, gathered to the plan")
                specs.append(planned)
            result[slot] = specs
        return result


def propagate(program, mesh=None, plan=None, batch_size: int = 64,
              block_id: int = 0, provenance=None,
              infer_shapes: bool = True) -> ShardingAnalysis:
    """Run the sharding-propagation pass; see the module docstring.
    `plan` is `{var: NamedSharding|PartitionSpec|spec-tuple}` (e.g.
    `ParallelExecutor.static_plan(program)`); `mesh` is inferred from
    the first NamedSharding when omitted.  `infer_shapes=False` skips
    the abstract-eval shape oracle (desc-only speed; shapeless helper
    vars then break the spec chain at reshape boundaries)."""
    return _Propagator(program, mesh=mesh, plan=plan,
                       batch_size=batch_size, block_id=block_id,
                       provenance=provenance,
                       infer_shapes=infer_shapes).run()


# ---------------------------------------------------------------------------
# communication pricing: wire cost over ICI/DCN, comm-aware roofline


# wire bytes per device = factor(kind, n) × buffer bytes (buffer = the
# collective's per-device OUTPUT, matching the HLO module convention)
# The JAX package's TPU v5e link rates (its cost table's "v5e" row),
# kept only so `comm_report(chip="tpu-v5e")` prices as the JAX package
# does and the tests can hold the two reports to each other; they are
# the TPU's, not the port's.
_JAX_REFERENCE_LINKS = {"tpu-v5e": {"ici_gbps": 45.0, "dcn_gbps": 6.25}}


def link_spec(chip: Optional[str] = None) -> dict:
    """{"chip", "ici_gbps", "dcn_gbps"}: the port's chip table (the card's
    spec on the card, ``cpu-host`` without one, when `chip` is None), or
    the JAX package's v5e rates for ``"tpu-v5e"``."""
    if chip in _JAX_REFERENCE_LINKS:
        return {"chip": chip, **_JAX_REFERENCE_LINKS[chip]}
    from .cost import chip_spec, detect_chip

    return chip_spec(chip or detect_chip())


def wire_factor(kind: str, n: int) -> float:
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n
    if kind in ("all-gather", "all-to-all"):
        return (n - 1) / n
    if kind == "reduce-scatter":
        return float(n - 1)  # buffer is the 1/n shard
    if kind == "collective-permute":
        return 1.0
    return 1.0


def comm_report(analysis: ShardingAnalysis, chip: Optional[str] = None,
                dcn: Optional[Iterable[str]] = None) -> dict:
    """Price the implied collectives over the chip's ICI and DCN links:
    per-kind/per-axis byte totals, wire bytes per LINK CLASS
    (``link_bytes``), and the predicted communication time that joins
    the roofline (`cost.roofline_with_comm`).

    A collective spanning BOTH link classes (a hybrid multi-slice mesh
    sharding one dim over ``("dcn_dp", "dp")``) is priced as GSPMD's
    hierarchical all-reduce decomposition: per-slice ICI reduce-scatter
    → DCN all-reduce of the 1/n_ici shard → per-slice ICI all-gather,
    so the slow DCN link carries only 1/n_ici of the buffer.  Hybrid
    all-gathers decompose the same way (ISSUE 20): DCN all-gather of the
    1/n_ici co-shard, then a per-slice ICI all-gather."""
    spec = link_spec(chip)
    dcn = set(dcn) if dcn is not None else set()
    for c in analysis.collectives:
        dcn.update(a for a in c.axes if str(a).startswith("dcn"))
    ici_bw = spec["ici_gbps"] * 1e9
    dcn_bw = spec["dcn_gbps"] * 1e9
    per_kind: Dict[str, dict] = {}
    per_axis: Dict[str, dict] = {}
    t_ici = t_dcn = 0.0
    link_bytes = {"ici": 0, "dcn": 0}
    breakdown = []
    for c in analysis.collectives:
        sizes = analysis.axis_sizes
        n_ici = n_dcn = 1
        for a in c.axes:
            if a in dcn:
                n_dcn *= int(sizes.get(a, 1))
            else:
                n_ici *= int(sizes.get(a, 1))
        n = n_ici * n_dcn
        decomposed = None
        if n_dcn > 1 and n_ici > 1 and c.kind == "all-reduce":
            # hierarchical hybrid all-reduce: ICI RS + AG move the same
            # wire bytes as a flat ICI all-reduce of the buffer; the
            # DCN all-reduce runs on the reduce-scattered 1/n_ici shard
            w_ici = wire_factor("all-reduce", n_ici) * c.bytes
            w_dcn = wire_factor("all-reduce", n_dcn) * (c.bytes // n_ici)
            decomposed = {
                "ici_reduce_scatter_bytes": int(
                    wire_factor("reduce-scatter", n_ici)
                    * (c.bytes // n_ici)),
                "dcn_all_reduce_bytes": int(w_dcn),
                "ici_all_gather_bytes": int(
                    wire_factor("all-gather", n_ici) * c.bytes),
            }
        elif n_dcn > 1 and n_ici > 1 and c.kind == "all-gather":
            # hierarchical hybrid all-gather: DCN all-gather of the
            # corresponding 1/n_ici co-shards first (each device then
            # holds its slice-local 1/n_ici chunk of the full buffer),
            # then a per-slice ICI all-gather completes the output — the
            # slow DCN link carries only 1/n_ici of the buffer instead
            # of the full gather a flat pricing would charge it
            w_dcn = wire_factor("all-gather", n_dcn) * (c.bytes // n_ici)
            w_ici = wire_factor("all-gather", n_ici) * c.bytes
            decomposed = {
                "dcn_all_gather_bytes": int(w_dcn),
                "ici_all_gather_bytes": int(w_ici),
            }
        elif n_dcn > 1:
            w_ici = 0.0
            w_dcn = wire_factor(c.kind, n) * c.bytes
        else:
            w_ici = wire_factor(c.kind, n) * c.bytes
            w_dcn = 0.0
        wire = w_ici + w_dcn
        t_ici += w_ici / ici_bw
        t_dcn += w_dcn / dcn_bw
        link_bytes["ici"] += int(w_ici)
        link_bytes["dcn"] += int(w_dcn)
        e = per_kind.setdefault(c.kind, {"count": 0, "bytes": 0,
                                         "wire_bytes": 0})
        e["count"] += 1
        e["bytes"] += c.bytes
        e["wire_bytes"] += int(wire)
        for a in c.axes:
            ax = per_axis.setdefault(a, {"count": 0, "bytes": 0,
                                         "dcn": a in dcn})
            ax["count"] += 1
            ax["bytes"] += c.bytes
        entry = {
            "kind": c.kind, "axes": list(c.axes), "bytes": c.bytes,
            "phase": c.phase, "var": c.var, "why": c.why}
        if decomposed is not None:
            entry["decomposed"] = decomposed
        breakdown.append(entry)
    return {
        "chip": spec["chip"],
        "collective_count": len(analysis.collectives),
        "collective_bytes": sum(c.bytes for c in analysis.collectives),
        "per_kind": per_kind,
        "per_axis": per_axis,
        "comm_time_s": t_ici + t_dcn,
        "ici_time_s": t_ici,
        "dcn_time_s": t_dcn,
        "dcn_axes": sorted(dcn),
        "link_bytes": link_bytes,
        "breakdown": breakdown,
    }


def scaling_curve(analysis: ShardingAnalysis, cost_report: dict,
                  axis: str, sizes: Sequence[int] = (1, 2, 4, 8, 16, 32),
                  chip: Optional[str] = None,
                  dcn: Optional[Iterable[str]] = None) -> List[dict]:
    """Predicted strong-scaling efficiency over `axis`: at each mesh
    size n, compute/memory time divide by n, collective buffers shrink
    only where batch-led (`scales_with_axes`), and the wire factor
    follows the algorithm — efficiency(n) = T(1) / (n · T(n)).  The
    analytic ceiling ROADMAP #2's pod-scale story is tested against."""
    spec = link_spec(chip)
    dcn = set(dcn or ())
    ici_bw = spec["ici_gbps"] * 1e9
    dcn_bw = spec["dcn_gbps"] * 1e9
    base = int(analysis.axis_sizes.get(axis, 1))
    # program_cost is sharding-unaware: its times ARE the n=1 point
    # (whole batch on one device); comm buffers were recorded per-device
    # at the CURRENT axis size, so batch-led ones rescale via base/n
    t_c1 = cost_report["compute_time_s"]
    t_m1 = cost_report["memory_time_s"]
    curve = []
    t1 = None
    for n in sizes:
        t_comm = 0.0
        for c in analysis.collectives:
            if axis not in c.axes:
                continue
            b = c.bytes
            if c.scales_with_axes and base:
                b = b * base // max(n, 1)
            wire = wire_factor(c.kind, n) * b
            t_comm += wire / (dcn_bw if (c.axes and set(c.axes) & dcn)
                              else ici_bw)
        t_n = max(t_c1 / n, t_m1 / n, t_comm)
        if t1 is None:
            t1 = max(t_c1, t_m1)
        eff = t1 / (n * t_n) if t_n else 0.0
        curve.append({"n": int(n), "step_time_s": t_n,
                      "comm_time_s": t_comm,
                      "efficiency": min(eff, 1.0)})
    return curve


def render_comm(report: dict, top: int = 10) -> str:
    def eng(x):
        for scale, pre in ((1 << 30, "GiB"), (1 << 20, "MiB"),
                           (1 << 10, "KiB")):
            if x >= scale:
                return f"{x / scale:.2f} {pre}"
        return f"{x} B"

    lines = [f"communication (static, chip={report['chip']})"]
    if not report["collective_count"]:
        lines.append("  no collectives implied")
        return "\n".join(lines)
    for kind, e in sorted(report["per_kind"].items(),
                          key=lambda kv: -kv[1]["bytes"]):
        lines.append(f"  {kind:<20} x{e['count']:<4} "
                     f"{eng(e['bytes']):>12} buffer "
                     f"({eng(e['wire_bytes'])} wire)")
    for a, e in sorted(report["per_axis"].items()):
        link = "DCN" if e["dcn"] else "ICI"
        lines.append(f"  axis {a:<15} x{e['count']:<4} "
                     f"{eng(e['bytes']):>12} over {link}")
    lines.append(f"  predicted comm time {report['comm_time_s'] * 1e6:.1f} us"
                 f" (ICI {report['ici_time_s'] * 1e6:.1f}"
                 f" / DCN {report['dcn_time_s'] * 1e6:.1f})")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# verifier bridge: PTV018-PTV021 findings from one analysis


def sharding_findings(program, plan, batch_size: int = 64,
                      block_id: int = 0, provenance=None, mesh=None,
                      dcn=None, replicated_threshold: int = 1 << 20,
                      analysis: Optional[ShardingAnalysis] = None):
    """Findings for the sharding rule family; called by
    `verify_program` when a plan is armed.  Returns (findings,
    analysis) so callers can reuse the propagation.  PTV020 needs mesh
    axis sizes to judge divisibility, so a bare-PartitionSpec plan
    (no NamedSharding, no `mesh=`) arms only PTV018/PTV019/PTV021."""
    from .verifier import Finding

    if analysis is None:
        analysis = propagate(program, mesh=mesh, plan=plan,
                             batch_size=batch_size, block_id=block_id,
                             provenance=provenance)
    findings = []
    for c in analysis.conflicts:
        findings.append(Finding(
            "PTV018", c["reason"], block=block_id, var=c.get("var")))
    for r in analysis.reshards:
        if not r.hot:
            continue
        findings.append(Finding(
            "PTV019",
            f"operand arrives as {r.src} but the op consumes it as "
            f"{r.dst} — an implicit reshard "
            f"({r.bytes} B gathered) re-paid every step",
            block=block_id, op=r.op, var=r.var))
    # PTV020: a big tensor left fully replicated that a mesh axis could
    # shard (advice-tier: INFO)
    sizes = analysis.axis_sizes
    block = program.blocks[block_id]
    for name, sharding in (plan or {}).items():
        spec = spec_of(sharding)
        if spec_axes(spec):
            continue
        v = block._find_var_recursive(name)
        if v is None or not v.persistable or v.shape is None:
            continue
        shape = bind_shape(v.shape, batch_size)
        n = 1
        for s in shape:
            n *= max(int(s), 1)
        bytes_ = n * dtype_bytes(v.dtype)
        if bytes_ < replicated_threshold:
            continue
        for axis, size in sizes.items():
            if size > 1 and shape and any(
                    int(s) % size == 0 and int(s) >= size
                    for s in shape):
                findings.append(Finding(
                    "PTV020",
                    f"{bytes_} B fully replicated; mesh axis "
                    f"{axis!r} (size {size}) divides its shape "
                    f"{tuple(shape)} — a sharding rule could cut "
                    f"per-device residency {size}x",
                    block=block_id, var=name))
                break
    dcn_set = set(dcn or ())
    for a in sizes:
        if str(a).startswith("dcn"):
            dcn_set.add(a)
    if dcn_set:
        for c in analysis.collectives:
            hit = [a for a in c.axes if a in dcn_set]
            if hit:
                findings.append(Finding(
                    "PTV021",
                    f"{c.kind} over DCN axis {hit[0]!r} inside the "
                    f"inner step ({c.bytes} B, {c.why or c.phase}) — "
                    f"DCN bandwidth is ~10x below ICI; move this "
                    f"collective out of the step or reshard so it "
                    f"rides ICI",
                    block=block_id, op=c.op, var=c.var))
    return findings, analysis
