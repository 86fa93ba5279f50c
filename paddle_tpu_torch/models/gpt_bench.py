"""The GPT bench model at full width, and the request sets that serve it.

The model is the repository's GPT bench configuration (``bench.py``'s GPT
model at ``_gpt_heads(512)``): vocab 32000, dim 512, 8 layers, 8 heads
(head dim 64), MLP x4, ``max_len`` 1024, float32; about 58.5 M parameters.
``chip_smoke.py`` and ``tools/profile_torch_serve.py`` both serve it, so
their numbers describe one workload.  ``prompts`` is the smoke's mixed
request set, ``prefix_prompts`` the prefix-heavy traffic of
``tools/serve_bench.py``, and ``damp_tail_layers`` gives random weights
the accept rate of a real model for speculative decoding, as serve_bench's
spec rows do.
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


def prefix_prompts(n: int = 16, seed: int = 0, pmin: int = 8,
                   pmax: int = 950):
    """`n` prefix-heavy prompts, drawn as ``tools/serve_bench.py``'s
    ``synth_prefix_requests`` draws them: one shared system prompt of 60%
    of `pmax`, then a suffix from 8 templates with Zipf(1.1) popularity,
    so whole prompts repeat too.  Tokens in [0, VOCAB).  At the default
    `pmax` the system prompt (570 tokens) ends mid-page, so a prompt whose
    suffix differs from an indexed one's copies the shared part of that
    page (copy-on-write) instead of recomputing it."""
    rng = np.random.RandomState(seed + 7919)
    rng.exponential(1.0, size=n)  # serve_bench's arrival draws
    sys_len = min(max(pmin, int(round(pmax * 0.6))), max(pmax - 1, 0))
    sys_prompt = rng.randint(0, VOCAB, size=sys_len).tolist()
    smax = max(1, pmax - sys_len)
    templates = [rng.randint(0, VOCAB,
                             size=rng.randint(1, smax + 1)).tolist()
                 for _ in range(8)]
    w = 1.0 / np.power(np.arange(1, 9), 1.1)
    w /= w.sum()
    return [sys_prompt + templates[rng.choice(8, p=w)] for _ in range(n)]


def damp_tail_layers(lm, scope, draft_layers: int, scale: float = 0.01):
    """Scale the residual-branch output projections (attention out and
    MLP down) of every layer at or past `draft_layers` by `scale`, in
    `scope`.  A random model's greedy stream is maximum-entropy, so a
    draft agrees with it at chance; damped tail layers make the target a
    near-identity refinement of the draft's trunk, the low-entropy regime
    of a real model (``tools/serve_bench.py`` ``damp_tail_layers``).  The
    weights are found by their place in ``lm._params``: per layer
    [ln1 s, ln1 b, wq, wk, wv, wo, ln2 s, ln2 b, w1, b1, w2, b2]."""
    per = lm._PER_LAYER
    for layer in range(int(draft_layers), lm.n_layers):
        for off in (5, 10):  # wo, w2
            p = lm._params[2 + per * layer + off]
            t = scope.find(p.name)
            if t is None:
                raise KeyError(f"damp_tail_layers: {p.name} is not in the "
                               f"scope")
            t.mul_(scale)
