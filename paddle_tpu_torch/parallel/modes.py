"""The parallelism-mode catalog, as declarative data — the port of
``paddle_tpu/parallel/modes.py`` (the same eleven modes, names and order).

Every analysis tool that reasons about "the modes" (the sharding
analyzer, the plan-equivalence sweep, ``analyze --sharding``, the
autotuner's ``mesh_layout`` axis) needs the same list without
copy-pasting model code.  Each entry declares how to BUILD the mode's
program and how the mode SHARDS it (mesh axes + ParallelExecutor
flags).

Programs are tiny (the dryrun shapes): the point is the sharding
structure, not the math.  `build()` constructs into the CURRENT default
program (callers `fluid.reset()` via build_mode) and returns the loss
var name; nothing runs here.  ``run_mode`` gives nine of the modes a
``ParallelExecutor`` and the two ``pipeline=True`` modes (``pp``,
``pp_dp``) a ``ProgramPipeline`` (``parallel/program_pipeline.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple


@dataclass(frozen=True)
class ParallelMode:
    """One dryrun parallelism mode: program builder + sharding config."""

    name: str
    doc: str
    mesh_axes: Dict[str, int]         # axis name -> size (8 devices total)
    build: Callable                   # () -> loss var (in default program)
    feed_names: Tuple[str, ...]
    executor_kwargs: Dict[str, object] = field(default_factory=dict)
    # feed builder for harnesses that RUN the mode (tools/hlo_analysis
    # comm): fn(rng, bs) -> feed dict; bs is already dp-divisible
    feed_fn: Optional[Callable] = None
    # modes driven by a pipeline executor (ProgramPipeline) rather than
    # ParallelExecutor: static analysis prices the stage-boundary
    # point-to-point traffic
    pipeline: bool = False


def _mlp_dp():
    import paddle_tpu_torch as fluid

    x = fluid.layers.data(name="x", shape=[64], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="int64")
    h = fluid.layers.fc(input=x, size=256, act="relu")
    h = fluid.layers.fc(input=h, size=256, act="relu")
    loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
        fluid.layers.fc(input=h, size=16), y))
    fluid.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    return loss.name


def _resnet_dp_mp():
    import paddle_tpu_torch as fluid
    from ..models import resnet

    img = fluid.layers.data(name="image", shape=[3, 32, 32],
                            dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    feat = resnet.resnet_cifar10(img, class_dim=10, depth=8)
    wide = fluid.layers.fc(input=feat, size=256, act="relu")  # mp-sharded
    head = fluid.layers.fc(input=wide, size=10)
    loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(head, label))
    fluid.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    return loss.name


def _attention_sp(sp_mode):
    def build():
        import paddle_tpu_torch as fluid

        T, D = 8, 32
        seq = fluid.layers.data(name="seq", shape=[T, D], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        attn = fluid.layers.multi_head_attention(
            seq, seq, seq, num_heads=4, causal=True, sp_mode=sp_mode)
        flat = fluid.layers.reshape(
            fluid.layers.elementwise_add(seq, attn), [-1, T * D])
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            fluid.layers.fc(input=flat, size=10), label))
        fluid.optimizer.Momentum(learning_rate=0.1,
                                 momentum=0.9).minimize(loss)
        return loss.name

    return build


def _pipeline_mlp(n_stages):
    def build():
        import paddle_tpu_torch as fluid

        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=32, act="tanh")
        if n_stages >= 2:
            fluid.layers.pipeline_stage()
        h = fluid.layers.fc(input=h, size=24, act="tanh")
        if n_stages >= 4:
            fluid.layers.pipeline_stage()
            h = fluid.layers.fc(input=h, size=24, act="tanh")
            fluid.layers.pipeline_stage()
        logits = fluid.layers.fc(input=h, size=4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        return loss.name

    return build


def _moe_ep():
    import paddle_tpu_torch as fluid

    x = fluid.layers.data(name="x", shape=[16], dtype="float32")
    y = fluid.layers.data(name="y", shape=[16], dtype="float32")
    out = fluid.layers.moe(x, num_experts=4, d_hidden=32,
                           capacity_factor=2.0)
    loss = fluid.layers.mean(
        fluid.layers.square_error_cost(input=out, label=y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss.name


def _lm_dp_sp():
    from ..models import transformer

    loss = transformer.build_lm_train_program(
        seq_len=16, vocab_size=64, dim=32, n_layers=1, n_heads=2,
        dtype="float32", learning_rate=1e-2)
    return loss.name


def _emb_mp():
    import paddle_tpu_torch as fluid

    ids = fluid.layers.data(name="ids", shape=[1], dtype="int64")
    y = fluid.layers.data(name="label", shape=[1], dtype="int64")
    emb = fluid.layers.embedding(ids, size=[128, 32])
    logits = fluid.layers.fc(input=emb, size=8)
    loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss.name


def _host_emb():
    import paddle_tpu_torch as fluid

    emb = fluid.layers.data(name="emb", shape=[16], dtype="float32")
    emb.stop_gradient = False
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    pred = fluid.layers.fc(emb, size=1, act="sigmoid")
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    fluid.optimizer.SGD(learning_rate=0.2).minimize(loss)
    return loss.name


def _feed_mlp(rng, bs):
    return {"x": rng.rand(bs, 64).astype("float32"),
            "y": rng.randint(0, 16, (bs, 1)).astype("int64")}


def _feed_resnet(rng, bs):
    return {"image": rng.rand(bs, 3, 32, 32).astype("float32"),
            "label": rng.randint(0, 10, (bs, 1)).astype("int64")}


def _feed_seq(rng, bs):
    return {"seq": rng.rand(bs, 8, 32).astype("float32"),
            "label": rng.randint(0, 10, (bs, 1)).astype("int64")}


def _feed_pp(rng, bs):
    return {"x": rng.rand(bs, 16).astype("float32"),
            "y": rng.randint(0, 4, (bs, 1)).astype("int64")}


def _feed_moe(rng, bs):
    x = rng.rand(8 * bs, 16).astype("float32")
    return {"x": x, "y": 2 * x}


def _feed_lm(rng, bs):
    import numpy as np

    toks = rng.randint(0, 64, (bs, 16, 1)).astype("int64")
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}


def _feed_emb(rng, bs):
    return {"ids": rng.randint(0, 128, (bs, 1)).astype("int64"),
            "label": rng.randint(0, 8, (bs, 1)).astype("int64")}


def _feed_host_emb(rng, bs):
    return {"emb": rng.rand(bs, 16).astype("float32"),
            "y": rng.rand(bs, 1).astype("float32")}


# the 8-device catalog, in dryrun phase order; names are stable (CI and
# the comm-validation harness key artifacts on them)
MODES: Tuple[ParallelMode, ...] = (
    ParallelMode(
        "dp", "pure data parallel MLP (grad all-reduce)",
        {"dp": 8}, _mlp_dp, ("x", "y"), feed_fn=_feed_mlp),
    ParallelMode(
        "dp_mp", "dp×mp ResNet tower + mp-sharded wide fc, ZeRO-1 "
        "optimizer-state sharding", {"dp": 4, "mp": 2}, _resnet_dp_mp,
        ("image", "label"), {"zero_dp_states": True},
        feed_fn=_feed_resnet),
    ParallelMode(
        "fsdp", "ZeRO-3: trainable params sharded 1/dp on dim 0",
        {"dp": 4, "mp": 2}, _resnet_dp_mp, ("image", "label"),
        {"fsdp_params": True}, feed_fn=_feed_resnet),
    ParallelMode(
        "sp_ring", "dp×sp ring attention (K/V rotate over "
        "collective-permute)", {"dp": 4, "sp": 2},
        _attention_sp("ring"), ("seq", "label"), feed_fn=_feed_seq),
    ParallelMode(
        "sp_ulysses", "dp×sp Ulysses attention (head scatter/gather "
        "all-to-all)", {"dp": 4, "sp": 2},
        _attention_sp("alltoall"), ("seq", "label"),
        feed_fn=_feed_seq),
    ParallelMode(
        "pp", "4-stage GPipe ProgramPipeline (stage-boundary "
        "point-to-point)", {"pp": 4}, _pipeline_mlp(4), ("x", "y"),
        pipeline=True, feed_fn=_feed_pp),
    ParallelMode(
        "ep_dp", "ep×dp mixture-of-experts (token dispatch/return "
        "all-to-all)", {"ep": 4, "dp": 2}, _moe_ep, ("x", "y"),
        feed_fn=_feed_moe),
    ParallelMode(
        "lm_dp_sp", "dp×sp transformer LM (flagship long-context step)",
        {"dp": 4, "sp": 2}, _lm_dp_sp, ("tokens", "targets"),
        feed_fn=_feed_lm),
    ParallelMode(
        "pp_dp", "pp×dp composed pipeline (stages × microbatch dp)",
        {"pp": 2, "dp": 4}, _pipeline_mlp(2), ("x", "y"),
        pipeline=True, feed_fn=_feed_pp),
    ParallelMode(
        "emb_mp", "vocab-sharded on-device embedding training",
        {"dp": 4, "mp": 2}, _emb_mp, ("ids", "label"),
        feed_fn=_feed_emb),
    ParallelMode(
        "host_emb", "host-offloaded embedding + dense SPMD tower",
        {"dp": 4, "mp": 2}, _host_emb, ("emb", "y"),
        feed_fn=_feed_host_emb),
)

MODE_NAMES: Tuple[str, ...] = tuple(m.name for m in MODES)


def get_mode(name: str) -> ParallelMode:
    for m in MODES:
        if m.name == name:
            return m
    raise KeyError(f"unknown parallelism mode {name!r} "
                   f"(have: {', '.join(MODE_NAMES)})")


def build_mode(name: str):
    """Reset the default program, build mode `name`, and return
    (mode, program, loss_name): the desc-side artifact every analysis
    consumer starts from."""
    import paddle_tpu_torch as fluid

    mode = get_mode(name)
    fluid.reset()
    loss_name = mode.build()
    return mode, fluid.default_main_program(), loss_name


def ensure_virtual_devices(n: int = 8, place=None):
    """`n` mesh positions for analysis or a run: the counterpart of the
    JAX package's virtual CPU devices.  ``place`` None is
    ``CUDAPlace(0)``: `n` positions on the card (repeated devices are the
    port's virtual devices); pass ``CPUPlace()`` for `n` positions on the
    CPU, as the tests do."""
    import torch

    from ..framework.place import CUDAPlace

    place = place if place is not None else CUDAPlace(0)
    dev = place.device
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ensure_virtual_devices: no CUDA device for CUDAPlace; pass "
            "CPUPlace() to put the positions on the CPU")
    return [torch.device(dev)] * int(n)


def logical_plan(mode: ParallelMode, program, mesh):
    """(partitioner, plan): the LOGICAL-AXIS-RULE declaration of `mode`
    — the same program sharded by `standard_logical_axis_rules` +
    `LogicalPartitioner` name inference instead of the mode's bespoke
    wiring.  The translation-validation engine
    (analysis/equivalence.mode_plan_equivalence) compares this plan and
    its propagated collective footprint against `mode_plan`'s: a mode
    whose two plans agree is PROVEN ready for the ROADMAP #2 collapse;
    a diverging mode's diff documents exactly which rule is missing
    from the logical table (e.g. the ZeRO-1/FSDP dim-0 reshard, the
    column-parallel >=128 width threshold)."""
    from ..analysis.sharding import (LogicalPartitioner,
                                     standard_logical_axis_rules)
    from .mesh import mesh_axis_sizes

    if dict(mode.mesh_axes) != mesh_axis_sizes(mesh):
        raise ValueError(
            f"mesh axes {mesh_axis_sizes(mesh)} do not match mode "
            f"{mode.name!r} ({dict(mode.mesh_axes)}) — a mismatched "
            f"pair would compare the wrong declaration")
    kw = dict(mode.executor_kwargs)
    lp = LogicalPartitioner(rules=standard_logical_axis_rules(
        zero_dp_states=bool(kw.get("zero_dp_states")),
        fsdp_params=bool(kw.get("fsdp_params"))))
    return lp, lp.plan(program, mesh)


def mode_plan(mode: ParallelMode, program, devices=None):
    """(mesh, plan, provenance) for one mode: the EFFECTIVE shardings
    its executor would constrain, from descs alone (`devices` None: the
    mode's positions on the CPU — nothing runs).  Pipeline modes
    plan like every other mode (rule family 4: ProgramPipeline shards
    microbatch feeds over 'dp' at runtime — `feeds_spec = P(None,
    'dp')` — so the static plan declares the same batch-led feeds;
    stage-split params stay replicated in the plan and the analyzer
    prices the stage boundaries via the pipeline_stage markers)."""
    from .mesh import make_mesh
    from .parallel_executor import ParallelExecutor

    if devices is None:
        import numpy as np
        import torch

        devices = [torch.device("cpu")] * int(
            np.prod(list(mode.mesh_axes.values())))
    mesh = make_mesh(dict(mode.mesh_axes), devices=devices)
    pe = ParallelExecutor(mesh=mesh, **dict(mode.executor_kwargs))
    provenance: Dict[str, str] = {}
    plan = pe.static_plan(program, provenance=provenance)
    return mesh, plan, provenance


def run_mode(name: str, devices=None, **executor_kwargs):
    """(mode, executor, program, loss_name) for running mode `name` over
    `devices` (default: the visible CUDA devices, as ``make_mesh`` takes
    them): the executor the mode declares.  A pipeline mode's executor is
    a ``ProgramPipeline`` over the mode's mesh and its forward program,
    ``n_micro`` (default: the mode's pp) microbatches a step and
    ``optimizer`` (default ``("sgd", 0.1)``, JAX's default); run the
    startup program before its first ``run``."""
    from .mesh import make_mesh
    from .parallel_executor import ParallelExecutor

    mode, program, loss_name = build_mode(name)
    mesh = make_mesh(dict(mode.mesh_axes), devices=devices)
    kw = {**dict(mode.executor_kwargs), **executor_kwargs}
    if mode.pipeline:
        from .program_pipeline import ProgramPipeline

        kw.setdefault("n_micro", mode.mesh_axes["pp"])
        return mode, ProgramPipeline(program, loss_name, mesh, **kw), \
            program, loss_name
    return mode, ParallelExecutor(mesh=mesh, **kw), program, loss_name
