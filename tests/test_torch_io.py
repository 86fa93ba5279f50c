"""Saving, loading and exchange (``paddle_tpu_torch/io.py``, the JSON form
of a program) against the JAX package on the CPU:

- ``Program.to_json`` equals the JAX package's, letter for letter, for a
  GPT, a fused ResNet and a ``While``/``ifelse`` program, and
  ``from_json`` of either parses back to it;
- an inference model saved by one package loads and runs in the other
  with the saver's fetches (f32: 1e-5 relative, two frameworks' CPU
  kernels), both ways, from ``__model__`` and from ``program.json``;
- a bf16 ``.npy`` is the JAX package's file to the byte, and the port
  reads it (and its own) back to the bit;
- ``prune`` and ``get_inference_program`` give the JAX package's
  programs; ``merge_model`` bundles load; an empty program is refused;
- persistables saved mid-training and loaded into a fresh scope give the
  uninterrupted next step, to the bit.

That a loaded value lands on a CUDA executor's device is checked on the
card (``tests/test_torch_io_card.py``)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import io as jio
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import transformer as ttransformer

V, D, L, NH, T = 48, 32, 2, 2, 8


@pytest.fixture(autouse=True)
def _fresh_port():
    tfluid.reset()
    jfluid.reset()
    yield


def _gpt_train(fl, transformer):
    return transformer.build_lm_train_program(
        seq_len=T, vocab_size=V, dim=D, n_layers=L, n_heads=NH,
        dtype="float32", learning_rate=1e-2)


def _resnet_train(fl, resnet):
    return resnet.build_train_program(
        depth=18, class_dim=10, image_shape=(3, 16, 16), layout="NHWC",
        fuse_bn=True)[0]


def _control_flow(fl, _models):
    x = fl.layers.data("x", shape=[4])
    i = fl.layers.fill_constant(shape=[1], dtype="float32", value=0)
    n = fl.layers.fill_constant(shape=[1], dtype="float32", value=3)
    total = fl.layers.fill_constant(shape=[1], dtype="float32", value=0)
    cond = fl.layers.less_than(i, n)
    w = fl.layers.While(cond)
    with w.block():
        fl.layers.assign(fl.layers.elementwise_add(total, i), total)
        fl.layers.increment(i, 1.0)
        fl.layers.less_than(i, n, cond=cond)
    flag = fl.layers.less_than(total, n)
    out = fl.layers.ifelse(flag, lambda: fl.layers.scale(x, scale=2.0),
                           lambda: fl.layers.scale(x, scale=-1.0))
    return out


PROGRAMS = {"gpt": lambda fl, m: _gpt_train(fl, m[0]),
            "resnet18_fused": lambda fl, m: _resnet_train(fl, m[1]),
            "while_ifelse": _control_flow}
MODELS = {"j": (jtransformer, jresnet), "t": (ttransformer, tresnet)}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_to_json_equals_jax(name):
    PROGRAMS[name](jfluid, MODELS["j"])
    PROGRAMS[name](tfluid, MODELS["t"])
    for get in (lambda f: f.default_main_program(),
                lambda f: f.default_startup_program()):
        want = get(jfluid).to_json()
        assert get(tfluid).to_json() == want
        back = tfluid.Program.from_json(want)
        assert back.to_json() == want
        assert jfluid.Program.from_json(back.to_json()).to_json() == want
    main = tfluid.Program.from_json(
        jfluid.default_main_program().to_json())
    assert main._next_uid == tfluid.default_main_program()._next_uid


# -- inference models across the packages -------------------------------------

def _gpt_infer(fl, transformer):
    tokens = fl.layers.data("tokens", shape=[T, 1], dtype="int64")
    logits = transformer.decoder_lm(tokens, V, D, L, NH, max_len=T,
                                    dropout_prob=0.1)
    return ["tokens"], fl.layers.softmax(logits)


def _resnet_infer(fl, resnet):
    img = fl.layers.data("image", shape=[16, 16, 3])
    logits = resnet.resnet_imagenet(img, class_dim=10, depth=18,
                                    layout="NHWC")
    return ["image"], fl.layers.softmax(logits)


def _feed(name):
    rng = np.random.RandomState(5)
    if name == "gpt":
        return {"tokens": rng.randint(0, V, (2, T, 1)).astype(np.int64)}
    return {"image": rng.rand(2, 16, 16, 3).astype(np.float32)}


INFER = {"gpt": (_gpt_infer, 0), "resnet18": (_resnet_infer, 1)}


def _save(fl, io, name, dirname):
    """Build, initialise (non-trivial BN statistics), save; returns the
    saver's own fetch on the feed."""
    build, which = INFER[name]
    feeds, out = build(fl, MODELS["j" if fl is jfluid else "t"][which])
    exe = fl.Executor(fl.CPUPlace())
    fl.default_startup_program().random_seed = 3
    exe.run(fl.default_startup_program())
    scope = fl.global_scope()
    rng = np.random.RandomState(9)
    for n, v in fl.default_main_program().global_block().vars.items():
        if n.startswith("batch_norm") and (".global_" in n or ".w_" in n):
            a = rng.rand(*v.shape).astype(np.float32) + 0.5
            scope.set(n, a if fl is tfluid else jnp.asarray(a))
    io.save_inference_model(dirname, feeds, [out], exe)
    (want,) = exe.run(fl.default_main_program(), feed=_feed(name),
                      fetch_list=[out])
    return np.asarray(want)


def _load_run(fl, io, name, dirname, json_only=False):
    if json_only:
        os.remove(os.path.join(dirname, "__model__"))
    exe = fl.Executor(fl.CPUPlace())
    prog, feeds, fetches = io.load_inference_model(dirname, exe)
    (got,) = exe.run(prog, feed=_feed(name), fetch_list=fetches)
    return np.asarray(got), prog


@pytest.mark.parametrize("name", sorted(INFER))
@pytest.mark.parametrize("way", ["jax_to_port", "port_to_jax",
                                 "jax_to_port_json"])
def test_inference_model_crosses_packages(name, way, tmp_path):
    d = str(tmp_path)
    src, dst = ((jfluid, jio), (tfluid, tio)) if way.startswith("jax") \
        else ((tfluid, tio), (jfluid, jio))
    want = _save(*src, name, d)
    got, prog = _load_run(*dst, name, d, json_only=way.endswith("json"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert all(op.attrs.get("is_test") for op in prog.global_block().ops
               if op.type in ("dropout", "batch_norm"))
    files = set(os.listdir(d))
    assert {"program.json", "meta.json", "persistables.json"} <= files
    assert ("__model__" in files) != way.endswith("json")


def test_saved_files_equal_jax(tmp_path):
    """Both packages save the same inference model: the same
    ``program.json``, ``__model__``, ``meta.json`` and persistables."""
    _save(jfluid, jio, "gpt", str(tmp_path / "j"))
    _save(tfluid, tio, "gpt", str(tmp_path / "t"))
    for fname in ("program.json", "__model__", "meta.json",
                  "persistables.json"):
        with open(tmp_path / "j" / fname, "rb") as a, \
                open(tmp_path / "t" / fname, "rb") as b:
            assert a.read() == b.read(), fname


# -- bf16 on disk ----------------------------------------------------------------

def test_bf16_npy_is_jax_bytes_and_round_trips(tmp_path):
    a = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jscope.set("w", jnp.asarray(a, dtype=jnp.bfloat16))
    t = torch.from_numpy(a).to(torch.bfloat16)
    tscope.set("w", t)
    jio.save_vars(str(tmp_path / "j"), ["w"], jscope)
    tio.save_vars(str(tmp_path / "t"), ["w"], tscope)
    jb = (tmp_path / "j" / "w.npy").read_bytes()
    assert (tmp_path / "t" / "w.npy").read_bytes() == jb
    assert b"'<V2'" in jb
    # the port reads both back to the bit, in bfloat16
    for d in ("j", "t"):
        back = tfluid.Scope()
        tio.load_vars(str(tmp_path / d), ["w"], back)
        got = back.find("w")
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), t.view(torch.int16))


def test_load_vars_casts_to_the_declared_dtype(tmp_path):
    main = tfluid.default_main_program()
    main.global_block().create_var(name="w", shape=[2, 3],
                                   dtype="bfloat16", persistable=True)
    np.save(tmp_path / "w.npy", np.ones((2, 3), np.float32))
    bits = np.full((2, 3), 0x3F80, np.uint16)  # 1.0 in bfloat16
    np.save(tmp_path / "u.npy", bits)
    main.global_block().create_var(name="u", shape=[2, 3],
                                   dtype="bfloat16", persistable=True)
    scope = tfluid.Scope()
    tio.load_vars(str(tmp_path), ["w", "u"], scope, main)
    for n in ("w", "u"):
        assert scope.find(n).dtype == torch.bfloat16, n
        assert torch.equal(scope.find(n).float(), torch.ones(2, 3)), n


# -- prune, merge, guards ----------------------------------------------------------

def test_prune_and_get_inference_program_equal_jax():
    jloss = _gpt_train(jfluid, jtransformer)
    tloss = _gpt_train(tfluid, ttransformer)
    jmain, tmain = jfluid.default_main_program(), \
        tfluid.default_main_program()
    jlogits = [op for op in jmain.global_block().ops
               if op.type == "mul"][-1].output_names()[0]
    for targets in ([jlogits], [jloss.name]):
        assert tio.prune(tmain, targets).to_json() == \
            jio.prune(jmain, targets).to_json()
        assert tio.get_inference_program(targets, tmain).to_json() == \
            jio.get_inference_program(targets, jmain).to_json()
    inf = tio.get_inference_program(tloss, tmain)
    assert not any(op.type in ("generic_grad", "adam")
                   for op in inf.global_block().ops)


def test_merge_model_round_trip(tmp_path):
    want = _save(tfluid, tio, "gpt", str(tmp_path / "m"))
    bundle = tio.merge_model(str(tmp_path / "m"), str(tmp_path / "m.tgz"))
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    prog, feeds, fetches = tio.load_merged_model(bundle, exe, scope)
    assert feeds == ["tokens"]
    (got,) = exe.run(prog, feed=_feed("gpt"), fetch_list=fetches,
                     scope=scope)
    np.testing.assert_array_equal(got, want)
    # the JAX package loads the port's bundle
    jprog, _, jfetch = jio.load_merged_model(
        bundle, jfluid.Executor(jfluid.CPUPlace()))
    assert jprog.to_json() == prog.to_json()


def test_empty_program_is_refused(tmp_path):
    with pytest.raises(ValueError, match="empty program"):
        tio.parse_program_bytes(b"")
    with pytest.raises(ValueError, match="empty program"):
        tio.parse_program_bytes(tfluid.Program().to_proto())
    (tmp_path / "program.json").write_text(tfluid.Program().to_json())
    with pytest.raises(ValueError, match="empty program"):
        tio.load_program_desc(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="meta.json"):
        tio.load_inference_model(str(tmp_path),
                                 tfluid.Executor(tfluid.CPUPlace()))
    (tmp_path / "meta.json").write_text(json.dumps({}))
    (tmp_path / "program.json").write_text(
        tfluid.Program.from_json(jfluid.Program().to_json()).to_json())
    with pytest.raises(ValueError, match="empty program"):
        tio.load_inference_model(str(tmp_path),
                                 tfluid.Executor(tfluid.CPUPlace()))


def test_save_params_and_persistables_resume_training(tmp_path):
    """Two steps, save; a fresh scope loads and takes step 3: its loss and
    every persistable equal the uninterrupted run's to the bit."""
    loss = _gpt_train(tfluid, ttransformer)
    main = tfluid.default_main_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    feed = {"tokens": _feed("gpt")["tokens"],
            "targets": np.roll(_feed("gpt")["tokens"], -1, axis=1)}
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[loss])
    tio.save_persistables(exe, str(tmp_path), main)
    tio.save_params(exe, str(tmp_path / "params"), main)
    (want,) = exe.run(main, feed=feed, fetch_list=[loss])
    names = json.loads((tmp_path / "persistables.json").read_text())
    assert sorted(names) == sorted(tio.persistable_names(main))
    fresh = tfluid.Scope()
    tio.load_persistables(exe, str(tmp_path), main, fresh)
    (got,) = exe.run(main, feed=feed, fetch_list=[loss], scope=fresh)
    np.testing.assert_array_equal(got, want)
    for n in names:
        np.testing.assert_array_equal(fresh.find_np(n),
                                      tfluid.global_scope().find_np(n), n)
    params = tfluid.Scope()
    tio.load_params(exe, str(tmp_path / "params"), main, params)
    assert sorted(params.local_names()) == sorted(
        p.name for p in main.global_block().all_parameters())
