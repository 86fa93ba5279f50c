"""Sharding assignment: the distribute transpiler — the port of
``paddle_tpu/parallel/transpiler.py``.

The reference's DistributeTranspiler (python/paddle/v2/fluid/
distribute_transpiler.py:34/76) rewrites a program into trainer programs with
send/recv ops plus per-pserver optimize programs.  Here distribution is not a
program rewrite at all: the transpiler assigns a `PartitionSpec` to every
variable, and the port's ParallelExecutor runs the program over the mesh
by that map, with the collectives it implies.  The 'transpiled program' is
the same program + a sharding map.

Since the partitioner collapse (ROADMAP #1) there are no bespoke spec
heuristics left in this module: `ShardingRules` is a thin CONFIG (axis
names + the ZeRO-1/FSDP flags) that derives a logical-axis rule table
(`analysis.sharding.standard_logical_axis_rules`), and the transpiler is
`LogicalPartitioner.plan` over that table.  Every bespoke rule the old
wiring hand-coded is now one table row:

  - feeds/activations: ("batch", dp) + ("length", sp)
  - 2-D weights last dim: ("mlp", mp, 128) — the ≥128 column-parallel gate
  - embeddings (lookup_table W): ("vocab", mp)
  - ZeRO-1 accumulator / FSDP param dim-0 reshard: ("state0"/"param0", dp)
  - hybrid ICI×DCN meshes: a `dcn_`-prefixed counterpart axis in the mesh
    widens the entry to a tuple — ("batch", ("dcn_dp", "dp"))

The deletion is covered by `prove_equivalent` verdicts: every mode's
rule-driven plan is PROVEN equal to the archived output of the deleted
wiring (parallel/mode_plans_golden.json, judged by
`analysis.equivalence.mode_plan_equivalence`).
"""

from __future__ import annotations

from typing import Dict, Optional


class ShardingRules:
    """Axis-name + flag config from which the logical rule table derives.

    `shard_params=False` (or `min_shard_dim > 2`) drops the mp
    weight/embedding rows — params stay replicated, feeds still shard.
    `zero_dp_states`/`fsdp_params` insert the dim-0 dp reshard rows
    (cross-replica weight-update sharding, arXiv:2004.13336)."""

    def __init__(self, dp_axis="dp", mp_axis="mp", sp_axis="sp",
                 shard_params=True, min_shard_dim=2,
                 zero_dp_states=False, fsdp_params=False):
        self.dp_axis = dp_axis
        self.mp_axis = mp_axis
        self.sp_axis = sp_axis
        self.shard_params = shard_params
        self.min_shard_dim = min_shard_dim
        self.zero_dp_states = bool(zero_dp_states or fsdp_params)
        self.fsdp_params = bool(fsdp_params)

    def _axis_size(self, mesh, name) -> int:
        from .mesh import axis_size

        return axis_size(mesh, name)

    def logical_rules(self, mesh=None) -> list:
        """The logical→mesh table this config declares.  With a mesh, a
        `dcn_`-prefixed counterpart axis (e.g. `dcn_dp` beside `dp`)
        widens the matching entries to hybrid tuples so one dim shards
        over both link classes."""
        from ..analysis.sharding import standard_logical_axis_rules

        dp, mp, sp = self.dp_axis, self.mp_axis, self.sp_axis
        if mesh is not None:
            from .mesh import mesh_axis_sizes

            sizes = mesh_axis_sizes(mesh)

            def hybrid(axis):
                outer = f"dcn_{axis}"
                return (outer, axis) if sizes.get(outer, 1) > 1 else axis

            dp, mp, sp = hybrid(dp), hybrid(mp), hybrid(sp)
        rules = standard_logical_axis_rules(
            dp_axis=dp, mp_axis=mp, sp_axis=sp,
            zero_dp_states=self.zero_dp_states,
            fsdp_params=self.fsdp_params)
        if not self.shard_params or self.min_shard_dim > 2:
            mp_axes = set(mp if isinstance(mp, tuple) else (mp,))
            rules = [r for r in rules
                     if not (r[0] in ("vocab", "mlp")
                             and r[1] is not None
                             and set(r[1] if isinstance(r[1], tuple)
                                     else (r[1],)) & mp_axes)]
        return rules


class DistributeTranspiler:
    """Assigns NamedShardings for a program over a mesh.

    transpile() returns {var_name: NamedSharding} for persistables and feeds;
    ParallelExecutor consumes it.  API parity with the reference's
    DistributeTranspiler.transpile(trainer_id, program, pservers, trainers) is
    kept loosely: one call, one plan, no program mutation needed.  The plan
    is `LogicalPartitioner.plan` over `rules.logical_rules(mesh)`;
    `last_provenance`/`last_conflicts` carry the per-var rule names and any
    PTV018 conflicts from the most recent transpile."""

    def __init__(self, rules: Optional[ShardingRules] = None,
                 zero_dp_states: bool = False, fsdp_params: bool = False):
        self.rules = rules or ShardingRules()
        if fsdp_params:
            self.rules.fsdp_params = True
            self.rules.zero_dp_states = True
        if zero_dp_states:
            self.rules.zero_dp_states = True
        self.last_provenance: Dict[str, str] = {}
        self.last_conflicts: list = []

    def transpile(self, program, mesh) -> Dict[str, object]:
        from ..analysis import contracts

        if contracts.should_wrap():
            # verified-in/verified-out (PADDLE_TPU_VERIFY=1): program must
            # verify, stay unmutated (both the version counter AND the
            # ISSUE-10 canonical-form identity proof — a plan-only pass
            # that edits descs is PTV022), and every plan key must be
            # declared
            return contracts.checked_sharding_plan(self, program, mesh)
        from ..analysis.sharding import LogicalPartitioner

        lp = LogicalPartitioner(rules=self.rules.logical_rules(mesh))
        provenance: Dict[str, str] = {}
        plan = lp.plan(program, mesh, provenance=provenance)
        self.last_provenance = provenance
        self.last_conflicts = list(lp.conflicts)
        return plan
