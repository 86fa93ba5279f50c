"""Saving and loading persistables and inference models, the port of
``paddle_tpu/io.py`` (reference python/paddle/v2/fluid/io.py:111/173/222/301,
operators/save_op.cc:59, load_op.cc:22, framework/prune.cc).

The file layout is the JAX package's, so either package reads what the
other wrote: one ``<name>.npy`` per variable, ``persistables.json`` (the
saved names), and for an inference model ``program.json``
(``Program.to_json``), ``__model__`` (the ProgramDef wire bytes of
``framework/proto_io.py``) and ``meta.json`` (feed and fetch names).

numpy has no bfloat16.  A bfloat16 value is saved as the JAX package saves
it: its raw bits as two-byte voids (``'<V2'``).  Loading reads ``|V2`` (and
``<u2``, bits as uint16) back as bfloat16, and casts every value to the
dtype the program declares for its name; a loaded value lands on the
executor's device (the JAX package's own ``load_vars`` cannot read its
bf16 files back: ``jnp.asarray`` refuses ``|V2``).

The save checks ``__model__`` with the native desc library
(``native/program_desc``) before it touches the directory, as the JAX
package's does.  The JAX save checks only when its library is prebuilt;
the port's library needs only g++ and builds at first use, so every save
validates, and a failed build raises.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from .framework.core import (Parameter, Program, default_main_program,
                             drop_orphaned_vars, torch_dtype)
from .framework.scope import Scope, global_scope, to_numpy


def _is_persistable(var) -> bool:
    return bool(var.persistable)


def _npy_path(dirname, name):
    return os.path.join(dirname, name + ".npy")


def _save_value(path, value):
    """One value as a ``.npy`` file (``write_value``)."""
    with open(path, "wb") as f:
        write_value(f, value)


def write_value(f, value):
    """One value in ``.npy`` format to the binary file `f`; bfloat16 as its
    bits with the JAX package's ``'<V2'`` header (the bytes ``np.save``
    writes for an ``ml_dtypes`` bfloat16 array)."""
    if isinstance(value, torch.Tensor) and value.dtype == torch.bfloat16:
        bits = value.detach().cpu().contiguous().view(torch.int16).numpy()
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": tuple(bits.shape)})
        f.write(bits.tobytes())
        return
    arr = to_numpy(value) if isinstance(value, torch.Tensor) \
        else np.asarray(value)
    np.save(f, arr, allow_pickle=False)


def _load_value(path, declared: Optional[str], device) -> torch.Tensor:
    """A ``.npy`` file (a path or a binary file) as a tensor on `device`
    in the `declared` dtype (the file's own when None)."""
    return array_to_tensor(np.load(path, allow_pickle=False), declared,
                           device)


def array_to_tensor(arr, declared: Optional[str], device) -> torch.Tensor:
    """A numpy array as a tensor on `device` in the `declared` dtype (the
    array's own when None); two-byte voids (``|V2``), and ``<u2`` where
    bfloat16 is declared, are bfloat16 bits."""
    arr = np.asarray(arr)
    if (arr.dtype.kind == "V" and arr.dtype.itemsize == 2) or (
            declared == "bfloat16" and arr.dtype == np.dtype("<u2")):
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                             .copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    dt = torch_dtype(declared) if declared else t.dtype
    return t.to(device=device, dtype=dt)


def save_vars(dirname, var_names, scope=None):
    scope = scope or global_scope()
    os.makedirs(dirname, exist_ok=True)
    for name in var_names:
        val = scope.find(name)
        if val is None:
            raise RuntimeError(f"save_vars: {name!r} not in scope")
        _save_value(_npy_path(dirname, name), val)


def load_vars(dirname, var_names, scope=None, main_program=None,
              executor=None):
    """Read each name's ``.npy`` into `scope`, in the dtype `main_program`
    declares for it (the file's own where it declares none), on
    `executor`'s device (else the device of the value it replaces, else
    the CPU)."""
    scope = scope or global_scope()
    block = main_program.global_block() if main_program is not None \
        else None
    for name in var_names:
        var = block._find_var_recursive(name) if block is not None else None
        if executor is not None:
            device = executor.device
        else:
            old = scope.find(name)
            device = old.device if old is not None else "cpu"
        scope.set(name, _load_value(_npy_path(dirname, name),
                                    var.dtype if var is not None else None,
                                    device))


def persistable_names(program: Optional[Program] = None) -> List[str]:
    program = program or default_main_program()
    return [v.name for v in program.global_block().vars.values()
            if _is_persistable(v)]


def save_persistables(executor, dirname, main_program=None, scope=None):
    """Every persistable variable of the program that the scope holds
    (parameters, optimizer accumulators, BatchNorm statistics)."""
    program = main_program or default_main_program()
    scope = scope or global_scope()
    names = [n for n in persistable_names(program) if scope.has(n)]
    save_vars(dirname, names, scope)
    with open(os.path.join(dirname, "persistables.json"), "w") as f:
        json.dump(names, f)


def load_persistables(executor, dirname, main_program=None, scope=None):
    """The names of ``persistables.json``, each on `executor`'s device in
    the dtype `main_program` (default: the default main program)
    declares.  ``paddle_tpu_torch.load_persistables`` (framework/scope.py)
    is another function: it carries numpy arrays in by name."""
    with open(os.path.join(dirname, "persistables.json")) as f:
        names = json.load(f)
    load_vars(dirname, names, scope or global_scope(),
              main_program or default_main_program(), executor)


def prune(program: Program, targets: List[str]) -> Program:
    """Drop the global block's ops not needed to compute `targets`
    (framework/prune.cc), and the declarations that leaves unused."""
    pruned = Program.from_json(program.to_json())
    block = pruned.global_block()
    needed = set(targets)
    keep = []
    for op in reversed(block.ops):
        if any(n in needed for n in op.output_names()):
            keep.append(op)
            needed.update(n for n in op.input_names() if n)
    block.ops = list(reversed(keep))
    drop_orphaned_vars(block, keep=targets)
    return pruned


def _strip_backward(program: Program, targets: List[str]) -> Program:
    """Remove grad/optimizer ops, keeping the forward subgraph for targets."""
    fwd = Program.from_json(program.to_json())
    block = fwd.global_block()
    block.ops = [
        op for op in block.ops
        if op.type not in ("generic_grad",)
        and not op.type.endswith("_grad")
        and "@GRAD" not in "".join(op.output_names())
    ]
    return prune(fwd, targets)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, scope=None,
                         fold_batch_norm=False):
    """Prune to the targets, force ``is_test`` on dropout and batch_norm,
    and save the program and the persistables it reads; returns the
    inference program.

    `fold_batch_norm=True` folds inference-mode BatchNorm into the conv
    filters first (``inference_transpiler.fuse_batch_norm``): the saved
    model carries the folded weights, written into a detached child scope,
    so the live scope is untouched.  ``__model__`` is validated first (see
    the module docstring): a refused program raises ``ValueError`` with the
    desc library's diagnostics and leaves no directory behind."""
    from .framework import proto_io
    from .native import program_desc

    program = main_program or default_main_program()
    target_names = [t.name if hasattr(t, "name") else t for t in target_vars]
    inference_program = _strip_backward(program, target_names)
    for op in inference_program.global_block().ops:
        if op.type in ("dropout", "batch_norm"):
            op.attrs["is_test"] = True
    scope = scope or global_scope()
    if fold_batch_norm:
        from .inference_transpiler import fuse_batch_norm

        # a detached overlay: the folded values mask the originals for the
        # save below, then go with it; a fetched conv output keeps its
        # raw value (the fold skips it)
        scope = Scope(parent=scope)
        fuse_batch_norm(inference_program, scope, fetch_names=target_names)
    # serialize and validate before touching the directory: a rejected or
    # unserializable program leaves no half-written model behind
    model_bytes = proto_io.serialize_program(inference_program)
    ok, diag = program_desc.validate(model_bytes)
    if not ok:
        raise ValueError(f"inference program failed validation:\n{diag}")
    os.makedirs(dirname, exist_ok=True)
    meta = {
        "feed_var_names": list(feeded_var_names),
        "fetch_var_names": target_names,
    }
    with open(os.path.join(dirname, "program.json"), "w") as f:
        f.write(inference_program.to_json())
    with open(os.path.join(dirname, "__model__"), "wb") as f:
        f.write(model_bytes)
    with open(os.path.join(dirname, "meta.json"), "w") as f:
        json.dump(meta, f)
    used = set()
    for op in inference_program.global_block().ops:
        used.update(op.input_names())
    # with the inference program's own persistables: the BN fold adds
    # bias vars that exist only there
    pnames = dict.fromkeys(persistable_names(program))
    pnames.update(dict.fromkeys(persistable_names(inference_program)))
    names = [n for n in pnames if n in used and scope.has(n)]
    save_vars(dirname, names, scope)
    with open(os.path.join(dirname, "persistables.json"), "w") as f:
        json.dump(names, f)
    return inference_program


def parse_program_bytes(data: bytes, origin: str = "<bytes>") -> Program:
    """Wire bytes -> Program, rejecting an empty program: empty or
    truncated bytes can parse to a desc without ops, which is a broken
    save, not a 0-op model."""
    from .framework import proto_io

    program = proto_io.parse_program(data)
    if not any(b.ops for b in program.blocks):
        raise ValueError(
            f"{origin} holds an empty program ({len(data)} bytes) — "
            f"truncated save?")
    return program


def load_program_desc(dirname):
    """Descs only, no scope side effects: (program, feed_names,
    fetch_names) from a saved model dir, from ``__model__`` where it is,
    else ``program.json``; the names are None without ``meta.json``."""
    model_path = os.path.join(dirname, "__model__")
    if os.path.exists(model_path):
        with open(model_path, "rb") as f:
            program = parse_program_bytes(f.read(), model_path)
    else:
        json_path = os.path.join(dirname, "program.json")
        with open(json_path) as f:
            program = Program.from_json(f.read())
        if not any(b.ops for b in program.blocks):
            raise ValueError(f"{json_path} holds an empty program — "
                             f"truncated save?")
    meta_path = os.path.join(dirname, "meta.json")
    if not os.path.exists(meta_path):
        return program, None, None
    with open(meta_path) as f:
        meta = json.load(f)
    return (program, meta.get("feed_var_names"),
            meta.get("fetch_var_names"))


def load_inference_model(dirname, executor, scope=None):
    """(program, feed_names, fetch_names); the persistables land in the
    scope on `executor`'s device, in the program's declared dtypes."""
    meta_path = os.path.join(dirname, "meta.json")
    if not os.path.exists(meta_path):
        raise FileNotFoundError(
            f"{meta_path} missing — not a saved inference model")
    program, feed_names, fetch_names = load_program_desc(dirname)
    if feed_names is None or fetch_names is None:
        raise KeyError(
            f"{meta_path} lacks feed_var_names/fetch_var_names — "
            f"corrupt or foreign meta file")
    load_persistables(executor, dirname, main_program=program, scope=scope)
    return program, feed_names, fetch_names


def merge_model(model_dir, out_path):
    """Bundle a saved inference model dir into one file (a gzipped tar of
    its contents)."""
    import tarfile

    with tarfile.open(out_path, "w:gz") as tar:
        for fname in sorted(os.listdir(model_dir)):
            tar.add(os.path.join(model_dir, fname), arcname=fname)
    return out_path


def load_merged_model(path, executor, scope=None):
    """Load a merge_model bundle → (program, feed_names, fetch_names)."""
    import tarfile
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        with tarfile.open(path, "r:gz") as tar:
            tar.extractall(tmp, filter="data")
        return load_inference_model(tmp, executor, scope=scope)


def _parameter_names(program):
    return [v.name for v in program.global_block().vars.values()
            if isinstance(v, Parameter)]


def save_params(executor, dirname, main_program=None, scope=None):
    """Save only the Parameter vars (not the optimizer state)."""
    prog = main_program or default_main_program()
    save_vars(dirname, _parameter_names(prog), scope=scope)


def load_params(executor, dirname, main_program=None, scope=None):
    prog = main_program or default_main_program()
    load_vars(dirname, _parameter_names(prog), scope, prog, executor)


def get_inference_program(target_vars, main_program=None):
    """Prune the program to the inference slice feeding target_vars
    (prune + strip backward)."""
    prog = main_program or default_main_program()
    tv = target_vars if isinstance(target_vars, (list, tuple)) \
        else [target_vars]
    names = [v if isinstance(v, str) else v.name for v in tv]
    return _strip_backward(prog, names)
