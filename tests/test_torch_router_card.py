"""The ReplicaRouter on the card: two v2 replicas over one small decoder
LM serve the same requests as two replicas on an explicit CPU place from
the same weights, through the paged attention kernels (K2, K3) and no
flash launch.  A CUDA engine has no CPU mode: every test here skips
without a CUDA device (decided in a fixture).  The file imports nothing
of JAX; on the chip machine run ``python -m pytest --noconftest
tests/test_torch_router_card.py``."""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.ops.cuda_kernels import flash_attention as fa
from paddle_tpu_torch.ops.cuda_kernels import paged_attention as pa
from paddle_tpu_torch.serving import ReplicaRouter, ServingEngine

V2 = dict(scheduler="v2", page_size=8, chunk_size=8, num_pages=12)


@pytest.fixture(autouse=True)
def _fresh():
    fluid.reset()
    yield


@pytest.fixture
def cuda_device():
    """The card, decided at test time, with f32 products in full f32;
    tests that need it skip here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the engines' place is the card")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _serve(lm, place, prompts):
    engines = [ServingEngine(lm, max_batch_size=n, place=place,
                             name=f"r{n}", **V2) for n in (2, 1)]
    router = ReplicaRouter(engines, chip="cpu-host")
    rids = [router.submit(p, 6) for p in prompts]
    fin = router.run()
    assert sorted(fin) == sorted(rids)
    assert router.stats()["pending_tokens"] == [0, 0]
    for e in engines:
        e.cache.prefix.clear()
        assert e.cache.allocator.available() == e.num_pages - 1
    return ([router.replica_of(r) for r in rids],
            [fin[r].generated for r in rids], engines)


def test_router_on_the_card_serves_as_on_the_cpu(cuda_device):
    lm = transformer.DecoderLM(50, 32, 2, 2, max_len=64, dtype="float32")
    lm.logits(fluid.layers.data("tokens", shape=[64, 1], dtype="int64"))
    fluid.default_startup_program().random_seed = 3
    fluid.Executor(fluid.CPUPlace()).run(fluid.default_startup_program())
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 50, size=int(k)).tolist()
               for k in rng.randint(4, 20, size=5)]
    cpu_place, cpu_tok, _ = _serve(lm, fluid.CPUPlace(), prompts)
    for k in (fa.flash_attention, pa.paged_attention, pa.paged_attention_mq):
        k.launches = 0
    card_place, card_tok, engines = _serve(lm, fluid.CUDAPlace(0), prompts)
    assert card_place == cpu_place
    assert card_tok == cpu_tok
    layers = 2
    assert fa.flash_attention.launches == 0
    assert pa.paged_attention_mq.launches == layers * sum(
        e.stats()["mixed_steps"] for e in engines)
    assert pa.paged_attention.launches == layers * sum(
        e.stats()["mixed_steps"] + e.stats()["decode_steps"]
        for e in engines)
