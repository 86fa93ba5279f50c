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
        "import paddle_tpu_torch.v1\n"
        "import paddle_tpu_torch.v1.trainer\n"
        "import paddle_tpu_torch.v1.evaluators\n"
        "import paddle_tpu_torch.trainer\n"
        "import paddle_tpu_torch.trainer.PyDataProvider2\n"
        "import paddle_tpu_torch.trainer.config_parser\n"
        "import paddle_tpu_torch.cli\n"
        "import paddle_tpu_torch.ops.ctc_ops\n"
        "import paddle_tpu_torch.ops.detection_ops\n"
        "import paddle_tpu_torch.analysis\n"
        "import paddle_tpu_torch.analysis.equivalence\n"
        "import paddle_tpu_torch.observability.tracing\n"
        "import paddle_tpu_torch.serving.router\n"
        "import paddle_tpu_torch.parallel\n"
        "import paddle_tpu_torch.parallel.modes\n"
        "import paddle_tpu_torch.parallel.ring_attention\n"
        "import paddle_tpu_torch.analysis.sharding\n"
        "import paddle_tpu_torch.ops.moe_ops\n"
        "import paddle_tpu_torch.parallel.pipeline\n"
        "import paddle_tpu_torch.parallel.program_pipeline\n"
        "import paddle_tpu_torch.parallel.moe\n"
        "import paddle_tpu_torch.distributed\n"
        "import paddle_tpu_torch.distributed.pserver\n"
        "import paddle_tpu_torch.distributed.distribute_transpiler\n"
        "import paddle_tpu_torch.distributed.host_embedding\n"
        "import paddle_tpu_torch.distributed.master\n"
        "import paddle_tpu_torch.distributed.checkpoint\n"
        "import paddle_tpu_torch.distributed.service\n"
        "import paddle_tpu_torch.distributed.chaos\n"
        "import paddle_tpu_torch.distributed.launch\n"
        "import paddle_tpu_torch.distributed.cluster_launch\n"
        "import paddle_tpu_torch.native.recordio\n"
        "import paddle_tpu_torch.v2\n"
        "import paddle_tpu_torch.v2.fluid\n"
        "import paddle_tpu_torch.v2.image\n"
        "import paddle_tpu_torch.v2.plot\n"
        "import paddle_tpu_torch.native\n"
        "import paddle_tpu_torch.native.program_desc\n"
        "import paddle_tpu_torch.native.capi\n"
        "import paddle_tpu_torch.capi_runtime\n"
        "import paddle_tpu_torch.compiler\n"
        "import paddle_tpu_torch.net_drawer\n"
        "import paddle_tpu_torch.proto\n"
        "import paddle_tpu_torch.utils\n"
        "import paddle_tpu_torch.utils.dump_config\n"
        "import paddle_tpu_torch.utils.make_model_diagram\n"
        "import paddle_tpu_torch.utils.merge_model\n"
        "import paddle_tpu_torch.utils.plotcurve\n"
        "import paddle_tpu_torch.utils.preprocess_img\n"
        "import paddle_tpu_torch.utils.show_pb\n"
        "import paddle_tpu_torch.utils.torch2paddle\n"
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
    # the step loop, the data plane, the training options, the model
    # zoo, the mesh tier (parallel/) and the host services
    # (distributed/) are among the scanned modules
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
            os.path.join("dataset", "conll05.py"),
            os.path.join("v1", "__init__.py"),
            os.path.join("v1", "activations.py"),
            os.path.join("v1", "attrs.py"),
            os.path.join("v1", "data_provider.py"),
            os.path.join("v1", "evaluators.py"),
            os.path.join("v1", "layers.py"),
            os.path.join("v1", "networks.py"),
            os.path.join("v1", "optimizers.py"),
            os.path.join("v1", "poolings.py"),
            os.path.join("v1", "trainer.py"),
            os.path.join("trainer", "__init__.py"),
            os.path.join("trainer", "PyDataProvider2.py"),
            os.path.join("trainer", "config_parser.py"),
            "cli.py", "__main__.py",
            os.path.join("ops", "ctc_ops.py"),
            os.path.join("ops", "detection_ops.py"),
            os.path.join("ops", "moe_ops.py"),
            os.path.join("analysis", "sharding.py"),
            os.path.join("parallel", "__init__.py"),
            os.path.join("parallel", "mesh.py"),
            os.path.join("parallel", "collectives.py"),
            os.path.join("parallel", "sharded.py"),
            os.path.join("parallel", "transpiler.py"),
            os.path.join("parallel", "parallel_executor.py"),
            os.path.join("parallel", "ring_attention.py"),
            os.path.join("parallel", "modes.py"),
            os.path.join("parallel", "pipeline.py"),
            os.path.join("parallel", "program_pipeline.py"),
            os.path.join("parallel", "moe.py"),
            os.path.join("distributed", "__init__.py"),
            os.path.join("distributed", "pserver.py"),
            os.path.join("distributed", "distribute_transpiler.py"),
            os.path.join("distributed", "host_embedding.py"),
            os.path.join("distributed", "master.py"),
            os.path.join("distributed", "checkpoint.py"),
            os.path.join("distributed", "service.py"),
            os.path.join("distributed", "chaos.py"),
            os.path.join("distributed", "launch.py"),
            os.path.join("distributed", "cluster_launch.py"),
            os.path.join("native", "__init__.py"),
            os.path.join("native", "recordio.py"),
            os.path.join("native", "program_desc.py"),
            os.path.join("native", "capi.py"),
            "capi_runtime.py", "compiler.py", "net_drawer.py",
            os.path.join("proto", "__init__.py"),
            *(os.path.join("utils", f"{m}.py") for m in UTILS_MODULES),
            *(os.path.join("v2", f"{m}.py") for m in V2_MODULES)} <= scanned


UTILS_MODULES = ("__init__", "dump_config", "make_model_diagram",
                 "merge_model", "plotcurve", "preprocess_img", "show_pb",
                 "torch2paddle")
V2_MODULES = ("__init__", "activation", "attr", "data_feeder", "data_type",
              "evaluator", "event", "fluid", "image", "inference", "layer",
              "master", "minibatch", "op", "parameters", "plot", "pooling",
              "topology", "trainer")


def test_v2_has_every_module_of_the_jax_v2():
    jax_v2 = os.path.join(_REPO, "paddle_tpu", "v2")
    assert sorted(f[:-3] for f in os.listdir(jax_v2) if f.endswith(".py")) \
        == sorted(V2_MODULES)
    assert all(os.path.exists(os.path.join(_PKG, "v2", f"{m}.py"))
               for m in V2_MODULES)


def test_v2_imports_without_pil_and_matplotlib():
    """``image`` needs PIL and ``plot`` matplotlib only inside their
    functions: with both blocked, ``paddle_tpu_torch.v2`` and its
    ``fluid`` alias import, load neither, and a Ploter collects."""
    code = (
        "import sys, json\n"
        "for m in ('PIL', 'PIL.Image', 'matplotlib', 'matplotlib.figure',\n"
        "          'matplotlib.backends.backend_agg'):\n"
        "    sys.modules[m] = None\n"
        "import paddle_tpu_torch.v2 as paddle\n"
        "import paddle_tpu_torch.v2.fluid\n"
        "p = paddle.plot.Ploter('train')\n"
        "p.append('train', 0, 1.0)\n"
        "assert p.plot() is None\n"
        "try:\n"
        "    paddle.image.resize_short(__import__('numpy').zeros((4, 4, 3),"
        " 'uint8'), 2)\n"
        "    raise SystemExit('image ran without PIL')\n"
        "except ImportError:\n"
        "    pass\n"
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
        get_op_info("no_such_op")
