"""Import torch parameters into a scope, the port of
``paddle_tpu/utils/torch2paddle.py`` (reference
python/paddle/utils/torch2paddle.py, which converted torch .t7 files into
paddle model files for weight transplants).

Consumes a ``torch.nn.Module.state_dict()`` (or any name -> tensor or
array mapping) and writes each value into the scope under its paddle
name, on the device and in the dtype of the value it replaces.  Linear
weights transpose: torch stores [out, in], the fc op multiplies with
[in, out]; an embedding table ([V, D] on both sides) does not."""

from __future__ import annotations

import numpy as np
import torch

from ..framework.scope import to_numpy

__all__ = ["state_dict_to_arrays", "torch_state_to_scope"]


def state_dict_to_arrays(state_dict, name_map=None, transpose_linear=True):
    """-> {paddle_name: np.ndarray}.  `name_map` maps torch param names to
    paddle var names (identity by default; a None target drops the
    entry).  A bfloat16 tensor widens to float32 (numpy has no
    bfloat16); the scope write casts it back."""
    out = {}
    for tname, value in state_dict.items():
        pname = (name_map or {}).get(tname, tname)
        if pname is None:
            continue
        arr = to_numpy(value) if isinstance(value, torch.Tensor) \
            else np.asarray(value)
        if transpose_linear and tname.endswith("weight") and arr.ndim == 2:
            arr = arr.T  # torch Linear [out,in] -> fc mul [in,out]
        out[pname] = np.ascontiguousarray(arr)
    return out


def torch_state_to_scope(state_dict, scope=None, name_map=None,
                         transpose_linear=True, strict=True):
    """Write converted values into the scope; with strict=True every
    target name must already exist there.  The transpose is decided per
    target against the SCOPE shape: an embedding table ([V, D] both sides)
    passes through, a Linear weight ([out, in] torch vs [in, out] fc)
    transposes; for square 2-D weights, where shapes cannot tell,
    `transpose_linear` and the 'weight' name suffix decide.  Returns the
    sorted names of the converted entries."""
    from ..framework.scope import global_scope

    scope = scope or global_scope()
    arrays = state_dict_to_arrays(state_dict, name_map,
                                  transpose_linear=False)
    tname_of = {(name_map or {}).get(t, t): t for t in state_dict}
    for name, arr in arrays.items():
        cur = scope.find(name)
        if cur is None:
            if strict:
                raise KeyError(
                    f"target parameter {name!r} not found in scope (run "
                    f"the startup program first, or pass name_map)")
            continue
        shape = tuple(cur.shape)
        if transpose_linear and arr.ndim == 2 \
                and shape != tuple(arr.shape) \
                and shape == tuple(arr.T.shape):
            arr = np.ascontiguousarray(arr.T)
        elif (arr.ndim == 2 and arr.shape[0] == arr.shape[1]
              and transpose_linear
              and tname_of.get(name, "").endswith("weight")):
            arr = np.ascontiguousarray(arr.T)
        if shape != tuple(arr.shape):
            raise ValueError(
                f"shape mismatch for {name!r}: scope {shape} vs "
                f"torch {arr.shape} "
                f"(transpose_linear={transpose_linear})")
        scope.set(name, torch.as_tensor(arr).to(device=cur.device,
                                                dtype=cur.dtype))
    return sorted(arrays)
