"""Program → pure callable, the port of ``paddle_tpu/compiler.py``.

``build_callable`` gives external tooling (the C inference API's peers,
export, a graft entry) a functional handle on a program: ``(fn, state)``
where ``fn(state, feeds) -> {fetch_name: tensor}`` runs the ops the
fetches need with the executor's own op walk (``framework/executor.py``)
on the device of the tensors it is given.  The JAX function is pure and
jittable; this one is pure and capturable: it reads no scope, writes
nothing back, moves nothing to the host and makes no host sync, so one
call can be captured by ``torch.cuda.graph`` and replayed (a warm-up call
first uploads the ops' constants, which the closure keeps).

``seal_cache_entry`` / ``unseal_cache_entry`` keep the JAX package's
sealed-entry format (magic + sha256 digest + payload, the same bytes).
The JAX module also wraps XLA's persistent executable cache
(``_IntegrityCache``, ``install_compile_cache_integrity``): atomic,
digest-checked entries so a process killed mid-write cannot poison later
ones.  The port has no such cache: its one persistent compiled artifact is
the kernel library, which is named by the hash of its sources and command
and published by ``os.replace`` (``ops/cuda_kernels/_common.py``), so a
torn write leaves no file under the name a reader opens; there is nothing
for a wrapper to wrap.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np
import torch

from .analysis.dataflow import state_classes
from .framework.core import torch_dtype
from .framework.executor import Executor
from .framework.scope import global_scope
from .ops.registry import EmitContext

# version-stamped magic so a future layout change invalidates cleanly
_SEAL_MAGIC = b"pdtpu-cc1\x00"
_SEAL_LEN = len(_SEAL_MAGIC) + 32  # magic + sha256


def seal_cache_entry(val: bytes) -> bytes:
    return _SEAL_MAGIC + hashlib.sha256(val).digest() + val


def unseal_cache_entry(raw: bytes) -> Optional[bytes]:
    """Payload bytes if `raw` is a sealed entry with a valid digest,
    else None (corrupt, truncated, or written by an unsealed producer)."""
    if raw is None or len(raw) < _SEAL_LEN \
            or not raw.startswith(_SEAL_MAGIC):
        return None
    body = raw[_SEAL_LEN:]
    if hashlib.sha256(body).digest() != raw[len(_SEAL_MAGIC):_SEAL_LEN]:
        return None
    return body


def _needed_ops(block, fetch_names):
    """The ops the fetches need, in order: backward from the fetches, an
    op is kept when it writes a needed name (its inputs become needed) or
    writes nothing at all (a side effect, as ``live_ops`` keeps it).  The
    block's written state is not a root: ``fn`` returns only fetches, as
    XLA drops the state updates of the JAX function's unreturned
    outputs."""
    needed = set(fetch_names)
    keep = []
    for op in reversed(block.ops):
        outs = [n for n in op.output_names() if n]
        if not outs or any(n in needed for n in outs):
            keep.append(op)
            needed.update(n for n in op.input_names() if n)
    return keep[::-1]


def build_callable(program, fetch_list, scope=None, feed_names=None,
                   is_test=True, rng_seed=0):
    """Returns (fn, state).

    fn(state, feeds) -> dict of fetches.  `state` holds the scope-resident
    persistables the block reads (parameters, BN statistics...), as the
    scope's tensors.  A feed that is not a tensor is moved to the state's
    device in its declared dtype (outside a capture; inside one, pass
    tensors already there).  `rng_seed` seeds the random ops' generators
    (``EmitContext.generator`` takes it as the run step)."""
    scope = scope or global_scope()
    # autotune winner pickup: build_callable has no feed signature, so it
    # reads the desc-only twin entry (`program_desc`) a `paddle tune` run
    # records beside the full one
    from .autotune.integration import maybe_apply_program_winner

    maybe_apply_program_winner(program, {})
    block = program.global_block()
    fetch_names = [f.name if hasattr(f, "name") else f for f in fetch_list]
    feed_names = feed_names or [
        v.name for v in block.vars.values() if v.is_data
    ]
    external_reads, rw_state, _ = state_classes(block, feed_names)
    missing = [n for n in external_reads + rw_state if not scope.has(n)]
    if missing:
        raise RuntimeError(
            f"build_callable: state vars not initialized: {missing[:5]}")
    state = {n: scope.find(n) for n in external_reads + rw_state}
    ops = _needed_ops(block, fetch_names)
    helper = Executor.__new__(Executor)
    constants = {}  # device → the ops' uploaded constants

    def fn(state, feeds):
        if any(op.type == "save" for op in block.ops):
            raise NotImplementedError(
                "save ops require Executor.run (its post-step host "
                "write); compiler.build_callable has no host side")
        tensors = [v for v in (*state.values(), *feeds.values())
                   if isinstance(v, torch.Tensor)]
        device = tensors[0].device if tensors else torch.device("cpu")
        env = dict(state)
        for name, value in feeds.items():
            var = block._find_var_recursive(name)
            dt = torch_dtype(var.dtype) if var is not None and var.dtype \
                else None
            if not isinstance(value, torch.Tensor):
                value = torch.as_tensor(np.asarray(value))
            env[name] = value.to(device=device, dtype=dt)
        ctx = EmitContext(device, is_test=is_test, program=program,
                          step=rng_seed,
                          constants=constants.setdefault(device, {}))
        ctx.lower_block = lambda idx, sub_env: helper._lower_block(
            ctx, idx, sub_env)
        with torch.no_grad():
            for op in ops:
                Executor._run_op(op, env, ctx)
        return {n: env[n] for n in fetch_names}

    return fn, state
