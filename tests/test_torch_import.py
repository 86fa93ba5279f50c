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
        "import paddle_tpu_torch.optimizer\n"
        "import paddle_tpu_torch.framework.backward\n"
        "import paddle_tpu_torch.serving\n"
        "import paddle_tpu_torch.ops.cuda_kernels._common\n"
        "import paddle_tpu_torch.lod\n"
        "import paddle_tpu_torch.ops.sequence_ops\n"
        "import paddle_tpu_torch.ops.cuda_kernels.lstm\n"
        "import paddle_tpu_torch.ops.cuda_kernels.gru\n"
        "import paddle_tpu_torch.models.image_models\n"
        "import paddle_tpu_torch.models.seq2seq\n"
        "import paddle_tpu_torch.models.rnn_bench\n"
        "import paddle_tpu_torch.models.resnet\n"
        "import paddle_tpu_torch.models.resnet_bench\n"
        "import paddle_tpu_torch.training_fusion\n"
        "import paddle_tpu_torch.autotune.knobs\n"
        "import paddle_tpu_torch.ops.cuda_kernels.bn_matmul\n"
        "import paddle_tpu_torch.ops.cuda_kernels.bn_conv\n"
        "import paddle_tpu_torch.framework.step_loop\n"
        "import paddle_tpu_torch.reader.decorator\n"
        "import paddle_tpu_torch.reader.creator\n"
        "import paddle_tpu_torch.data_feeder\n"
        "import paddle_tpu_torch.regularizer\n"
        "import paddle_tpu_torch.clip\n"
        "import paddle_tpu_torch.learning_rate_decay\n"
        "import paddle_tpu_torch.nets\n"
        "import paddle_tpu_torch.dataset.common\n"
        "import paddle_tpu_torch.dataset.mnist\n"
        "import paddle_tpu_torch.dataset.uci_housing\n"
        "import paddle_tpu_torch.ops.control_flow_ops\n"
        "import paddle_tpu_torch.layers.ops\n"
        "import paddle_tpu_torch.layers.control_flow\n"
        "import paddle_tpu_torch.io\n"
        "import paddle_tpu_torch.framework.proto_io\n"
        "import paddle_tpu_torch.inference_transpiler\n"
        "import paddle_tpu_torch.layers.math_helper\n"
        "import paddle_tpu_torch.models\n"
        "import paddle_tpu_torch.models.vgg\n"
        "import paddle_tpu_torch.models.unet\n"
        "import paddle_tpu_torch.models.deepfm\n"
        "import paddle_tpu_torch.models.standing\n"
        "import paddle_tpu_torch.models.zoo_bench\n"
        "import paddle_tpu_torch.ops.crf_ops\n"
        "import paddle_tpu_torch.evaluator\n"
        "import paddle_tpu_torch.dataset.conll05\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'paddle_tpu' or m.startswith('paddle_tpu.')\n"
        "             or m == 'ml_dtypes' or m.startswith('ml_dtypes.')\n"
        "             or m == 'google.protobuf'\n"
        "             or m.startswith('google.protobuf.'))\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|paddle_tpu|ml_dtypes|"
    r"google\.protobuf)\b", re.M)


def test_source_scan_has_no_jax_or_paddle_tpu_import():
    hits, scanned = [], set()
    for dirpath, _, files in os.walk(_PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                scanned.add(os.path.relpath(path, _PKG))
                with open(path, encoding="utf-8") as fh:
                    for m in _FORBIDDEN.finditer(fh.read()):
                        hits.append(f"{os.path.relpath(path, _REPO)}: "
                                    f"{m.group(0).strip()}")
    assert not hits, hits
    # the step loop, the data plane, the training options and the model
    # zoo are among the scanned modules
    assert {os.path.join("framework", "step_loop.py"),
            os.path.join("reader", "__init__.py"),
            os.path.join("reader", "decorator.py"),
            os.path.join("reader", "creator.py"),
            "data_feeder.py", "regularizer.py", "clip.py",
            "learning_rate_decay.py", "nets.py",
            os.path.join("dataset", "__init__.py"),
            os.path.join("dataset", "common.py"),
            os.path.join("dataset", "mnist.py"),
            os.path.join("dataset", "uci_housing.py"),
            os.path.join("ops", "control_flow_ops.py"),
            os.path.join("layers", "ops.py"),
            os.path.join("layers", "control_flow.py"),
            "io.py", "inference_transpiler.py",
            os.path.join("framework", "proto_io.py"),
            os.path.join("layers", "math_helper.py"),
            os.path.join("models", "vgg.py"),
            os.path.join("models", "unet.py"),
            os.path.join("models", "deepfm.py"),
            os.path.join("models", "standing.py"),
            os.path.join("models", "zoo_bench.py"),
            os.path.join("ops", "crf_ops.py"), "evaluator.py",
            os.path.join("dataset", "conll05.py")} <= scanned


def test_source_scan_pattern_is_word_bounded():
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from paddle_tpu.serving import x")
    assert _FORBIDDEN.search("import paddle_tpu")
    assert not _FORBIDDEN.search("import paddle_tpu_torch")
    assert not _FORBIDDEN.search("from paddle_tpu_torch.ops import x")
    assert not _FORBIDDEN.search("import jaxtyping")
    assert _FORBIDDEN.search("from google.protobuf import text_format")
    assert _FORBIDDEN.search("import ml_dtypes")


def test_default_place_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        paddle_tpu_torch.default_place()
    with pytest.raises(RuntimeError):
        paddle_tpu_torch.Executor()


def test_get_places_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        paddle_tpu_torch.layers.get_places()
    assert paddle_tpu_torch.layers.get_places(1, "cpu") == \
        [paddle_tpu_torch.CPUPlace()]


def test_places_carry_torch_devices():
    assert paddle_tpu_torch.CPUPlace().device == torch.device("cpu")
    assert paddle_tpu_torch.CUDAPlace(1).device == torch.device("cuda", 1)
    assert paddle_tpu_torch.CPUPlace() == paddle_tpu_torch.CPUPlace()
    assert paddle_tpu_torch.CUDAPlace(0) != paddle_tpu_torch.CUDAPlace(1)
    assert not hasattr(paddle_tpu_torch, "TPUPlace")


def test_unregistered_op_raises_key_error():
    from paddle_tpu_torch.ops.registry import get_op_info

    with pytest.raises(KeyError, match="no torch emitter"):
        get_op_info("warpctc")
