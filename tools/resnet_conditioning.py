"""How far float32 training of the port's ResNet lies from float64: a
measure of how tightly two float32 runs (the card and the CPU, or two
frameworks) can be held to each other at a given size.

Usage (repository root):

    python3 tools/resnet_conditioning.py [--depth 50] [--image 64] [--bs 4]
                                         [--steps 3] [--class-dim 1000]
                                         [--card]

Builds the fused NHWC training program of ``models/resnet_bench.py`` in
float64 and in float32 (Momentum 0.001), runs its startup once in float64,
loads the same state into both, and takes ``--steps`` steps of each on the
CPU on the same feed; ``--card`` adds the float32 run on the CUDA card
(TF32 off), from the same state.  ``--jax`` (on the CPU, with the JAX
package) makes the JAX package's float64 run from its own startup state
the reference, and adds its float32 run and the port's float64 run from
that state.  Prints one JSON line: for each run, each step's loss and its
relative difference from the float64 reference; for step 1,
each parameter gradient's float32 error relative to the float64
gradient's max |g| (the worst four and the stem, first fused 3x3, BN
scale and fc weight gradients that ``chip_smoke.py`` compares), and the
same errors as norms (||g32 - g64|| / ||g64||, each and over all
gradients together); and the running statistics' largest error after the
last step.  A few ReLU inputs
within a rounding of 0 flip sides between the two runs; each flip moves
one gradient element by its whole value, which the max-based error shows
and the norm-based one mostly does not.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch.models import resnet_bench  # noqa: E402


def _build(pkg, dtype, depth, image, class_dim):
    """(the package's fluid module, the loss) of the fused NHWC training
    program, built into fresh default programs."""
    if pkg == "jax":
        import paddle_tpu as jfluid
        from paddle_tpu.models import resnet as jresnet

        jfluid.reset()
        loss, _ = jresnet.build_train_program(
            depth=depth, class_dim=class_dim, image_shape=(3, image, image),
            dtype=dtype, learning_rate=0.001,
            momentum=resnet_bench.MOMENTUM, layout="NHWC", fuse_bn=True)
        return jfluid, loss
    fluid.reset()
    loss, _ = resnet_bench.train_program(depth=depth, image=image,
                                         class_dim=class_dim, dtype=dtype,
                                         learning_rate=0.001)
    return fluid, loss


def _run(pkg, dtype, depth, image, bs, class_dim, steps, state, place=None):
    f, loss = _build(pkg, dtype, depth, image, class_dim)
    main = f.default_main_program()
    block = main.global_block()
    exe = f.Executor(place or f.CPUPlace())
    if state is None or pkg == "jax":
        exe.run(f.default_startup_program())
    if state is None:
        state = {n: f.global_scope().find_np(n)
                 for n, v in block.vars.items() if v.persistable}
    elif pkg == "jax":
        import jax.numpy as jnp

        for n, a in state.items():
            f.global_scope().set(n, jnp.asarray(a.astype(block.vars[n].dtype)))
    else:
        fluid.load_persistables(main, {n: a.astype(block.vars[n].dtype)
                                       for n, a in state.items()})
    grads = sorted(p.name + "@GRAD" for p in block.all_parameters())
    conv3 = next(op for op in block.ops if op.type == "bn_act_conv3x3")
    watched = ["conv2d_0.w_0@GRAD", conv3.inputs["Filter"][0] + "@GRAD",
               conv3.inputs["Scale"][0] + "@GRAD", "fc_0.w_0@GRAD"]
    feed = resnet_bench.feed(bs, image, class_dim)
    feed["image"] = feed["image"].astype(dtype)
    losses, first = [], None
    for step in range(steps):
        out = exe.run(main, feed=feed,
                      fetch_list=[loss] + (grads if step == 0 else []))
        losses.append(float(np.asarray(out[0]).ravel()[0]))
        if step == 0:
            first = {n: np.asarray(g) for n, g in zip(grads, out[1:])}
    stats = {op.inputs[s][0]: f.global_scope().find_np(op.inputs[s][0])
             for op in block.ops if op.type == "batch_norm"
             for s in ("Mean", "Variance")}
    return state, losses, first, stats, watched


def _report(l32, g32, s32, l64, g64, s64, watched):
    def max_err(n):
        return float(np.abs(g32[n] - g64[n]).max()
                     / (np.abs(g64[n]).max() + 1e-30))

    def norm_err(n):
        return float(np.linalg.norm(g32[n] - g64[n])
                     / (np.linalg.norm(g64[n]) + 1e-30))

    all_norm = (sum(float(np.sum((g32[n] - g64[n]) ** 2)) for n in g64)
                / sum(float(np.sum(g64[n] ** 2)) for n in g64)) ** 0.5
    worst = sorted(g64, key=max_err, reverse=True)[:4]
    return {"losses_f32": l32,
            "loss_rel_err": [abs(x - y) / abs(y) for x, y in zip(l32, l64)],
            "grad_max_rel_err_step1_worst": {n: max_err(n) for n in worst},
            "grad_max_rel_err_step1_all_params": max(map(max_err, g64)),
            "grad_norm_rel_err_step1_all_params": max(map(norm_err, g64)),
            "grad_norm_rel_err_step1_together": all_norm,
            "grad_max_rel_err_step1_watched": {n: max_err(n)
                                               for n in watched},
            "grad_norm_rel_err_step1_watched": {n: norm_err(n)
                                                for n in watched},
            "stats_max_rel_err_last_step": max(
                float(np.abs(s32[n] - s64[n]).max()
                      / max(np.abs(s64[n]).max(), 1e-12)) for n in s64)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--depth", type=int, default=50)
    ap.add_argument("--image", type=int, default=64)
    ap.add_argument("--bs", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--class-dim", type=int, default=1000)
    ap.add_argument("--card", action="store_true")
    ap.add_argument("--jax", action="store_true")
    a = ap.parse_args(argv)
    args = (a.depth, a.image, a.bs, a.class_dim, a.steps)
    ref = "jax" if a.jax else "port"
    if a.jax:
        import jax

        jax.config.update("jax_enable_x64", True)
    state, l64, g64, s64, watched = _run(ref, "float64", *args, None)
    out = {"depth": a.depth, "image": a.image, "bs": a.bs,
           "class_dim": a.class_dim, "reference": ref + " float64",
           "losses_f64": l64}
    runs = {"cpu": ("port", "float32", None)}
    if a.jax:
        runs.update(jax=("jax", "float32", None),
                    port_f64=("port", "float64", None))
    if a.card:
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        runs["card"] = ("port", "float32", fluid.CUDAPlace(0))
        out["card"] = torch.cuda.get_device_name(0)
    for where, (pkg, dtype, place) in runs.items():
        _, l32, g32, s32, _ = _run(pkg, dtype, *args, state, place)
        out[where] = _report(l32, g32, s32, l64, g64, s64, watched)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
