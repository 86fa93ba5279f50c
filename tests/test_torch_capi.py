"""The port's C inference API (``native/capi`` over ``capi_runtime``) and
``compiler.build_callable`` against the JAX package's, on the CPU.

The C API runs here with ``PADDLE_TPU_TORCH_CAPI_PLACE=cpu``, the caller
asking for the CPU: each package's library loads a model saved by either
package and gives outputs within 1e-6 of the other's, the errors are the
same, and a C program with no Python of its own (``tests/test_capi.py``'s
``C_MAIN``, and ``native/capi_demo.c``) runs through the port's library.
``build_callable``'s function equals JAX's jitted one within 1e-5 from the
same numpy state, with the same errors; the sealed cache entries are the
same bytes."""

import ctypes
import os
import subprocess
import time

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import capi_runtime as jrt
from paddle_tpu import compiler as jcompiler
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.native import capi as jcapi
from paddle_tpu_torch import capi_runtime as trt
from paddle_tpu_torch import compiler as tcompiler
from paddle_tpu_torch.autotune import integration as tint
from paddle_tpu_torch.autotune import knobs as tknobs
from paddle_tpu_torch.autotune import store as tstore
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.native import capi as tcapi

from test_capi import C_MAIN  # noqa: E402

CPU = tfluid.CPUPlace()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W_TARGET = np.array([[1.0], [2.0], [-1.0], [0.5]], np.float32)
X = np.array([[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 1.0, 2.0]], np.float32)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    tfluid.reset()
    jfluid.reset()
    monkeypatch.setenv(trt.PLACE_ENV, "cpu")
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE", str(tmp_path / "at"))
    tint.reset()
    yield
    tint.reset()


def _regressor(fl, place, d, bf16_fetch=False):
    """tests/test_capi.py's regressor, trained 60 seeded SGD steps and
    saved as an inference model in `d`."""
    fl.reset()
    x = fl.layers.data("x", shape=[4], dtype="float32")
    pred = fl.layers.fc(x, size=1)
    label = fl.layers.data("y", shape=[1], dtype="float32")
    cost = fl.layers.mean(fl.layers.square_error_cost(pred, label))
    fl.optimizer.SGD(learning_rate=0.1).minimize(cost)
    exe = fl.Executor(place)
    exe.run(fl.default_startup_program())
    rng = np.random.RandomState(0)
    for _ in range(60):
        xb = rng.randn(32, 4).astype(np.float32)
        exe.run(feed={"x": xb, "y": xb @ W_TARGET}, fetch_list=[cost])
    out = fl.layers.cast(pred, "bfloat16") if bf16_fetch else pred
    fl.io.save_inference_model(d, ["x"], [out], exe)
    return d


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The regressor saved by each package, and the port's with a bf16
    fetch; both C libraries built."""
    root = tmp_path_factory.mktemp("capi")
    # tests/test_capi.py may be building the JAX library beside its
    # source in another worker: wait out its link
    for _ in range(5):
        if jcapi.load() is not None:
            break
        time.sleep(2)
    assert jcapi.load() is not None, "the JAX C API does not build"
    tcapi.load()
    return {"jax": _regressor(jfluid, jfluid.CPUPlace(), str(root / "j")),
            "port": _regressor(tfluid, CPU, str(root / "t")),
            "bf16": _regressor(tfluid, CPU, str(root / "b"), True)}


def test_each_c_api_loads_both_saves(models):
    outs = {}
    for pkg, capi in (("jax", jcapi), ("port", tcapi)):
        for saved in ("jax", "port"):
            eng = capi.InferenceEngine(models[saved])
            (out,) = eng.run({"x": X})
            (out2,) = eng.run({"x": 2 * X})  # the engine is reused
            eng.close()
            assert out.dtype == np.float32 and out.shape == (2, 1)
            np.testing.assert_allclose(out2, 2 * out, rtol=1e-5, atol=1e-6)
            outs[pkg, saved] = out
    for saved in ("jax", "port"):
        np.testing.assert_allclose(outs["port", saved], outs["jax", saved],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(outs["port", saved], X @ W_TARGET,
                                   atol=0.15)


def test_errors_as_jax(models):
    for capi in (jcapi, tcapi):
        eng = capi.InferenceEngine(models["port"])
        with pytest.raises(RuntimeError, match="unknown feed 'bogus'"):
            eng.run({"bogus": np.zeros((1, 4), np.float32)})
        with pytest.raises(RuntimeError, match=r"missing feeds: \['x'\]"):
            eng.run({})
        with pytest.raises(KeyError):  # no code for float16 either side
            eng.run({"x": X.astype(np.float16)})
        eng.close()
    # a bf16 fetch: the runtime refuses a code, never guesses one
    msgs = []
    for rt in (jrt, trt):
        h = rt.create(models["bf16"])
        rt.set_input(h, "x", X.tobytes(), X.shape, 0)
        assert rt.run(h) == 1
        with pytest.raises(TypeError, match="no C ABI code") as e:
            rt.output_dtype(h, 0)
        msgs.append(str(e.value))
        rt.release(h)
    assert msgs[0] == msgs[1]
    with pytest.raises(KeyError, match="unknown feed"):
        trt.set_input(trt.create(models["port"]), "bogus", X.tobytes(),
                      X.shape, 0)
    # through the C ABI the port's shim raises where JAX's reads float32
    eng = tcapi.InferenceEngine(models["bf16"])
    with pytest.raises(RuntimeError, match="has dtype bfloat16"):
        eng.run({"x": X})
    eng.close()


def test_place_comes_from_the_environment(models, monkeypatch):
    monkeypatch.setenv(trt.PLACE_ENV, "tpu")
    with pytest.raises(RuntimeError, match="use 'cuda'"):
        tcapi.InferenceEngine(models["port"])
    if torch.cuda.is_available():
        return  # the default place is a card there
    monkeypatch.delenv(trt.PLACE_ENV)
    dll = tcapi.load()
    h = ctypes.c_int64()
    assert dll.paddle_inference_create(models["port"].encode(),
                                       ctypes.byref(h)) == -1
    assert "runs on a CUDA device by default" in \
        dll.paddle_capi_last_error().decode()


def test_standalone_c_programs(models, tmp_path):
    """tests/test_capi.py's C_MAIN built unchanged against the port's
    header, and capi_demo.c, each a process with no Python of its own."""
    src = tmp_path / "main.c"
    src.write_text(C_MAIN)
    c_main = tcapi.build_demo(str(src), str(tmp_path / "c_main"))
    demo = tcapi.build_demo()
    env = tcapi.embed_env()
    xin, xout = tmp_path / "x.bin", tmp_path / "out.bin"
    X.tofile(xin)
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for cmd in ([c_main, models["port"], REPO],
                         [demo, models["port"], REPO, "x", "0", "2,4",
                          str(xin), str(xout)])]
    (o1, e1), (o2, e2) = [p.communicate(timeout=240) for p in procs]
    assert procs[0].returncode == 0, e1
    assert procs[1].returncode == 0, e2
    exe = tfluid.Executor(CPU)
    prog, feeds, fetches = tfluid.io.load_inference_model(
        models["port"], exe)
    want = exe.run(prog, feed={"x": X}, fetch_list=fetches)[0]
    assert o1.startswith("CAPI_OK")
    np.testing.assert_allclose([float(v) for v in o1.split()[1:3]],
                               want.ravel(), atol=1e-3)
    fields = o2.split("\n")[-2].split()
    assert fields[:5] == ["CAPI_OK", "0", "2", "2", "1"]
    np.testing.assert_array_equal(
        np.fromfile(xout, np.float32).reshape(2, 1), want)


# -- build_callable -------------------------------------------------------------


def _fc(fl):
    x = fl.layers.data("x", shape=[4], dtype="float32")
    h = fl.layers.fc(x, size=8, act="relu")
    return fl.layers.fc(h, size=3)


def _gpt(fl):
    transformer = ttransformer if fl is tfluid else jtransformer
    tokens = fl.layers.data("tokens", shape=[8, 1], dtype="int64")
    return transformer.decoder_lm(tokens, 64, 32, 2, 4, max_len=8,
                                  dtype="float32")


FEEDS = {"fc": {"x": np.random.RandomState(1).randn(5, 4)
                .astype(np.float32)},
         "gpt": {"tokens": np.random.RandomState(2).randint(
             0, 64, (3, 8, 1)).astype(np.int64)}}


@pytest.mark.parametrize("name", ["fc", "gpt"])
def test_build_callable_equals_jax(name):
    build = {"fc": _fc, "gpt": _gpt}[name]
    jout = build(jfluid)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    jfn, jstate = jcompiler.build_callable(
        jfluid.default_main_program(), [jout])
    tout = build(tfluid)
    assert tout.name == jout.name
    tscope = tfluid.global_scope()
    for n, v in jstate.items():
        tscope.set(n, np.asarray(v))
    tfn, tstate = tcompiler.build_callable(
        tfluid.default_main_program(), [tout])
    assert sorted(tstate) == sorted(jstate)
    feeds = FEEDS[name]
    want = np.asarray(jax.jit(jfn)(jstate, feeds)[jout.name])
    got = tfn(tstate, feeds)[tout.name]
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # pure: the same call again gives the same bits, the state untouched
    np.testing.assert_array_equal(tfn(tstate, feeds)[tout.name].numpy(),
                                  got.numpy())


def test_build_callable_errors_as_jax(tmp_path):
    msgs = []
    for fl, compiler in ((jfluid, jcompiler), (tfluid, tcompiler)):
        out = _fc(fl)
        with pytest.raises(RuntimeError) as e:
            compiler.build_callable(fl.default_main_program(), [out])
        msgs.append(str(e.value))
        fl.Executor(fl.CPUPlace()).run(fl.default_startup_program())
        block = fl.default_main_program().global_block()
        block.append_op("save", inputs={"X": [out.name]}, outputs={},
                        attrs={"file_path": str(tmp_path / fl.__name__)})
        fn, state = compiler.build_callable(fl.default_main_program(), [out])
        with pytest.raises(NotImplementedError,
                           match="save ops require Executor.run"):
            fn(state, FEEDS["fc"])
    assert msgs[0] == msgs[1]
    assert msgs[1].startswith("build_callable: state vars not initialized")


def test_build_callable_desc_only_pickup():
    """tests/test_autotune.py's case on the port: a winner stored for the
    program's desc alone applies (remat marks) when the callable is
    built."""
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.framework.core import Program, program_guard

    main, startup = Program(), Program()
    with unique_name.guard(), program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4])
        y = tfluid.layers.data(name="y", shape=[1])
        cost = tfluid.layers.mean(tfluid.layers.square_error_cost(
            tfluid.layers.fc(input=x, size=1), y))
        tfluid.optimizer.SGD(learning_rate=0.01).minimize(cost)
    kind, backend = tknobs.platform(init=True)
    digest = tint.program_site(main, {})["program_digest"]
    tstore.default_store().record("program_desc",
                                  {"program_digest": digest}, kind, backend,
                                  {"remat": True})
    tint.reset()
    scope = tfluid.Scope()
    tfluid.Executor(CPU).run(startup, scope=scope)
    tcompiler.build_callable(main, [cost], scope=scope,
                             feed_names=["x", "y"])
    assert any(op.attrs.get("__remat__") for op in main.global_block().ops)


def test_seal_bytes_and_rejections_as_jax():
    val = b"executable-bytes" * 100
    sealed = tcompiler.seal_cache_entry(val)
    assert sealed == jcompiler.seal_cache_entry(val)
    tampered = bytearray(sealed)
    tampered[-1] ^= 1
    for raw in (sealed, sealed[:-3], b"\x28\xb5\x2f\xfd" + val,
                bytes(tampered), b""):
        assert tcompiler.unseal_cache_entry(raw) == \
            jcompiler.unseal_cache_entry(raw)
    assert tcompiler.unseal_cache_entry(sealed) == val
    assert tcompiler.unseal_cache_entry(sealed[:-3]) is None
    assert tcompiler.unseal_cache_entry(bytes(tampered)) is None
