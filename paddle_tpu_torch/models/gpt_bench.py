"""The GPT bench model at full width, and a request set that serves it.

The model is the repository's GPT bench configuration (``bench.py``'s GPT
model at ``_gpt_heads(512)``): vocab 32000, dim 512, 8 layers, 8 heads
(head dim 64), MLP x4, ``max_len`` 1024, float32; about 58.5 M parameters.
``chip_smoke.py`` and ``tools/profile_torch_serve.py`` both serve it, so
their numbers describe one workload.
"""

from __future__ import annotations

import numpy as np

VOCAB, DIM, LAYERS, HEADS, MAX_LEN = 32000, 512, 8, 8, 1024


def build(place, seed: int = 0):
    """A fresh DecoderLM with its tower built and its startup program run
    on `place` with random weights from `seed`.  Resets the default
    programs and the global scope first."""
    import paddle_tpu_torch as fluid

    from .transformer import DecoderLM

    fluid.reset()
    lm = DecoderLM(VOCAB, DIM, LAYERS, HEADS, max_len=MAX_LEN,
                   dtype="float32")
    lm.logits(fluid.layers.data("tokens", shape=[MAX_LEN, 1],
                                dtype="int64"))
    startup = fluid.default_startup_program()
    startup.random_seed = seed
    fluid.Executor(place).run(startup)
    return lm


def prompts(n: int = 16, seed: int = 0):
    """`n` prompts with lengths drawn from RandomState(seed) in [5, 960]
    and tokens in [1, VOCAB); at least four are longer than 128, so the
    prefill buckets 256, 512 and 1024 appear."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(5, 961, size=n)
    if (lens > 128).sum() < 4:
        raise ValueError(f"prompt lengths {lens}: fewer than 4 > 128")
    return [rng.randint(1, VOCAB, size=int(k)).tolist() for k in lens]
