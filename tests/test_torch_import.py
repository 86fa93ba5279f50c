"""The port's package boundary: ``paddle_tpu_torch`` loads neither JAX nor
anything of the JAX package ``paddle_tpu``, and its entry points default
to the card, never to the CPU."""

import os
import re
import subprocess
import sys

import pytest
import torch

import paddle_tpu_torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_REPO, "paddle_tpu_torch")


@pytest.fixture(autouse=True)
def _fresh_port():
    paddle_tpu_torch.reset()
    yield


def test_import_loads_no_jax_and_no_paddle_tpu():
    """Import the package and every module of the slice in a fresh
    interpreter; no ``jax*`` and no ``paddle_tpu`` / ``paddle_tpu.*``
    module may be loaded (``paddle_tpu_torch`` shares the prefix, so the
    check is on the dotted name, not the string prefix)."""
    code = (
        "import sys, json\n"
        "import paddle_tpu_torch\n"
        "import paddle_tpu_torch.models.transformer\n"
        "import paddle_tpu_torch.serving\n"
        "import paddle_tpu_torch.ops.cuda_kernels._common\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'paddle_tpu' or m.startswith('paddle_tpu.'))\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|paddle_tpu)\b", re.M)


def test_source_scan_has_no_jax_or_paddle_tpu_import():
    hits = []
    for dirpath, _, files in os.walk(_PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path, encoding="utf-8") as fh:
                    for m in _FORBIDDEN.finditer(fh.read()):
                        hits.append(f"{os.path.relpath(path, _REPO)}: "
                                    f"{m.group(0).strip()}")
    assert not hits, hits


def test_source_scan_pattern_is_word_bounded():
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from paddle_tpu.serving import x")
    assert _FORBIDDEN.search("import paddle_tpu")
    assert not _FORBIDDEN.search("import paddle_tpu_torch")
    assert not _FORBIDDEN.search("from paddle_tpu_torch.ops import x")
    assert not _FORBIDDEN.search("import jaxtyping")


def test_default_place_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        paddle_tpu_torch.default_place()
    with pytest.raises(RuntimeError):
        paddle_tpu_torch.Executor()


def test_places_carry_torch_devices():
    assert paddle_tpu_torch.CPUPlace().device == torch.device("cpu")
    assert paddle_tpu_torch.CUDAPlace(1).device == torch.device("cuda", 1)
    assert paddle_tpu_torch.CPUPlace() == paddle_tpu_torch.CPUPlace()
    assert paddle_tpu_torch.CUDAPlace(0) != paddle_tpu_torch.CUDAPlace(1)
    assert not hasattr(paddle_tpu_torch, "TPUPlace")


def test_unregistered_op_raises_key_error():
    from paddle_tpu_torch.ops.registry import get_op_info

    with pytest.raises(KeyError, match="no torch emitter"):
        get_op_info("lookup_table")
