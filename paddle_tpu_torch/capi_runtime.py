"""In-process runtime behind the C inference API
(``paddle_tpu_torch/native/capi.cc``), the port of
``paddle_tpu/capi_runtime.py``.

The reference's `paddle/capi` exposed C symbols over gserver inference
(capi/gradient_machine.h:36 paddle_gradient_machine_create_for_inference);
its trainer embedded a Python interpreter for config parsing
(utils/PythonUtil.h:47).  ``libpaddle_capi`` does both: it embeds CPython
and drives these functions, so a C or C++ program runs a saved model
through a stable C ABI.

Handles are integers; tensor payloads cross the boundary as raw bytes +
shape + dtype code (0=float32, 1=int64, 2=int32, 3=float64).  An unknown
feed raises KeyError, a missing one ValueError, an output dtype with no
code (bfloat16) TypeError: the C client never gets a guessed code.

An engine runs on ``default_place()``, the card, and raises without one.
``PADDLE_TPU_TORCH_CAPI_PLACE`` is the caller's way to ask otherwise:
unset or ``cuda`` is the card, ``cpu`` the CPU, anything else raises (the
counterpart of the JAX runtime's reading of ``JAX_PLATFORMS``).
"""

from __future__ import annotations

import os
import threading
from typing import Dict

import numpy as np
import torch

PLACE_ENV = "PADDLE_TPU_TORCH_CAPI_PLACE"

_DTYPES = {0: np.float32, 1: np.int64, 2: np.int32, 3: np.float64}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}
_TORCH_CODES = {torch.float32: 0, torch.int64: 1, torch.int32: 2,
                torch.float64: 3}

_lock = threading.Lock()
_engines: Dict[int, "_Engine"] = {}
_next_handle = 1


def engine_place():
    """The place ``PADDLE_TPU_TORCH_CAPI_PLACE`` names (the card when it
    is unset)."""
    from .framework.place import CPUPlace, default_place

    want = os.environ.get(PLACE_ENV, "")
    if want in ("", "cuda"):
        return default_place()
    if want == "cpu":
        return CPUPlace()
    raise ValueError(f"{PLACE_ENV}={want!r}: use 'cuda' (the default) or "
                     f"'cpu'")


class _Engine:
    def __init__(self, model_dir: str):
        from . import io
        from .framework.executor import Executor
        from .framework.scope import Scope

        self.scope = Scope()
        self.exe = Executor(engine_place())
        self.program, self.feed_names, self.fetch_names = \
            io.load_inference_model(model_dir, self.exe, scope=self.scope)
        self.inputs: Dict[str, np.ndarray] = {}
        self.outputs = []


def create(model_dir: str) -> int:
    global _next_handle
    eng = _Engine(model_dir)
    with _lock:
        h = _next_handle
        _next_handle += 1
        _engines[h] = eng
    return h


def set_input(handle: int, name: str, data: bytes, shape, dtype_code: int):
    eng = _engines[handle]
    # a copy: the bytes object is read-only, and the feed outlives the call
    arr = np.frombuffer(data, dtype=_DTYPES[int(dtype_code)]).reshape(
        [int(s) for s in shape]).copy()
    if name not in eng.feed_names:
        raise KeyError(f"unknown feed {name!r}; expected {eng.feed_names}")
    eng.inputs[name] = arr
    return 0


def run(handle: int) -> int:
    eng = _engines[handle]
    missing = [n for n in eng.feed_names if n not in eng.inputs]
    if missing:
        raise ValueError(f"missing feeds: {missing}")
    eng.outputs = eng.exe.run(eng.program, feed=dict(eng.inputs),
                              fetch_list=list(eng.fetch_names),
                              scope=eng.scope, return_numpy=False)
    return len(eng.outputs)


def output_shape(handle: int, idx: int) -> bytes:
    t = _engines[handle].outputs[int(idx)]
    return np.asarray(tuple(t.shape), np.int64).tobytes()


def output_dtype(handle: int, idx: int) -> int:
    t = _engines[handle].outputs[int(idx)]
    code = _TORCH_CODES.get(t.dtype)
    if code is None:
        # never guess: a wrong code makes the C client misread the buffer
        dtype = str(t.dtype).replace("torch.", "")
        raise TypeError(f"output {idx} has dtype {dtype} with no C ABI "
                        f"code; cast the fetch var to one of "
                        f"{sorted(str(d) for d in _DTYPE_CODES)}")
    return code


def output_data(handle: int, idx: int) -> bytes:
    idx = int(idx)
    output_dtype(handle, idx)  # raises for a dtype the C side cannot read
    t = _engines[handle].outputs[idx]
    return t.detach().cpu().contiguous().numpy().tobytes()


def release(handle: int) -> int:
    with _lock:
        _engines.pop(int(handle), None)
    return 0


def shutdown() -> int:
    """Drop every engine and wait for the card's work: called by
    ``paddle_capi_shutdown`` before it finalizes an interpreter it
    created."""
    with _lock:
        _engines.clear()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return 0
