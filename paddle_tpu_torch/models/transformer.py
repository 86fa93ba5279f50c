"""Decoder-only transformer language model (GPT-style): the tower builder
``decoder_lm`` and ``DecoderLM``'s paged serving path, ported from
``paddle_tpu/models/transformer.py``.

Architecture: pre-LN residual blocks (LN → causal MHA → +x; LN → MLP
gelu → +x), learned position embeddings, final LN, untied LM head.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import layers
from ..framework.core import Parameter, default_main_program, torch_dtype
from ..framework.initializer import NormalInitializer
from ..framework.layer_helper import LayerHelper


def _positions(tokens, dim, max_len, dtype):
    """Learned position table [max_len, D] sliced to the program's T."""
    T = tokens.shape[1]
    if T is None or T > max_len:
        raise ValueError(f"sequence length {T} exceeds max_len={max_len}")
    table = layers.create_parameter(
        [max_len, dim], dtype,
        default_initializer=NormalInitializer(scale=0.02))
    helper = LayerHelper("position_slice")
    pos = helper.create_tmp_variable(dtype, shape=(T, dim))
    helper.append_op("slice", inputs={"Input": [table.name]},
                     outputs={"Out": [pos.name]},
                     attrs={"axes": [0], "starts": [0], "ends": [int(T)]})
    return pos


def decoder_lm(tokens, vocab_size, dim, n_layers, n_heads, max_len,
               mlp_ratio=4, dtype="float32"):
    """tokens [B, T, 1] int64 → logits [B, T, vocab_size]."""
    emb = layers.embedding(tokens, size=[vocab_size, dim], dtype=dtype)
    pos = _positions(tokens, dim, max_len, dtype)
    x = layers.elementwise_add(emb, pos, axis=1)
    for _ in range(n_layers):
        h = layers.layer_norm(x, begin_norm_axis=2)
        a = layers.multi_head_attention(h, h, h, num_heads=n_heads,
                                        causal=True)
        x = layers.elementwise_add(x, a)
        h = layers.layer_norm(x, begin_norm_axis=2)
        m = layers.fc(h, dim * mlp_ratio, num_flatten_dims=2, act="gelu")
        m = layers.fc(m, dim, num_flatten_dims=2)
        x = layers.elementwise_add(x, m)
    x = layers.layer_norm(x, begin_norm_axis=2)
    return layers.fc(x, vocab_size, num_flatten_dims=2, bias_attr=False)


class DecoderLM:
    """Decoder-only LM with the paged serving path.

    `logits(tokens)` builds the tower via decoder_lm and RECORDS its
    parameters in creation order; the serving ops (`prefill`,
    `decode_step`) wire those same parameters into their slots, and the
    values are shared through the scope by name."""

    # creation order inside decoder_lm: emb W, pos table, then per layer
    # [ln1 s, ln1 b, wq, wk, wv, wo, ln2 s, ln2 b, w1, b1, w2, b2],
    # then final [ln s, ln b, head w]
    _PER_LAYER = 12

    def __init__(self, vocab_size, dim, n_layers, n_heads, max_len,
                 mlp_ratio=4, dtype="float32"):
        self.vocab_size, self.dim = vocab_size, dim
        self.n_layers, self.n_heads = n_layers, n_heads
        self.max_len, self.mlp_ratio = max_len, mlp_ratio
        self.dtype = dtype
        self._params = None

    def logits(self, tokens):
        if self._params is not None:
            raise RuntimeError(
                "DecoderLM.logits() already built this model's tower — "
                "one instance owns one parameter set")
        block = default_main_program().global_block()
        before = set(block.vars)
        out = decoder_lm(tokens, self.vocab_size, self.dim, self.n_layers,
                         self.n_heads, self.max_len,
                         mlp_ratio=self.mlp_ratio, dtype=self.dtype)
        new = [v for n, v in block.vars.items()
               if n not in before and isinstance(v, Parameter)]
        want = 2 + self._PER_LAYER * self.n_layers + 3
        if len(new) != want:
            raise RuntimeError(f"tower created {len(new)} parameters, "
                               f"expected {want}")
        self._params = new
        return out

    def load_params(self, arrays, scope):
        """Write `arrays` — numpy parameter values in creation order (the
        order of the JAX model's ``_params``) — into `scope` under this
        model's own parameter names.  A value lands on the device of the
        tensor it replaces (the CPU when the name is new), in the
        parameter's dtype; shapes must match."""
        if self._params is None:
            raise RuntimeError("build the tower with .logits() first")
        arrays = list(arrays)
        if len(arrays) != len(self._params):
            raise ValueError(f"{len(arrays)} arrays for "
                             f"{len(self._params)} parameters")
        for p, a in zip(self._params, arrays):
            a = np.asarray(a)
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"parameter {p.name}: shape {a.shape} != "
                                 f"{p.shape}")
            old = scope.find(p.name)
            device = old.device if old is not None else "cpu"
            scope.set(p.name, torch.tensor(a, device=device,
                                           dtype=torch_dtype(p.dtype)))

    def declare_kv_cache(self, num_pages, page_size, name="paged_kv"):
        """Declare the paged K/V pool variables [L, num_pages, nh, ps, dh]
        in the CURRENT program and return them as the `cache` pair.  Their
        values live in the scope under these names, so the engine's
        prefill and decode programs share one physical cache."""
        dh = self.dim // self.n_heads
        shape = (self.n_layers, int(num_pages), self.n_heads,
                 int(page_size), dh)
        gb = default_main_program().global_block()

        def mk(s):
            return gb.create_var(name=f"{name}.{s}", shape=shape,
                                 dtype=self.dtype, persistable=True,
                                 stop_gradient=True)

        return mk("k"), mk("v")

    def prefill(self, prompt, prompt_len, page_table, cache, page_size):
        """Append a paged_prefill op: write the prompt's K/V into `cache`
        through `page_table` and return the first greedy token [B] int64.
        prompt [B,P,1] is bucket-padded; prompt_len [B,1] carries the
        real lengths."""
        if self._params is None:
            raise RuntimeError("build the tower with .logits() first")
        kpool, vpool = cache
        helper = LayerHelper("paged_prefill")
        tok = helper.create_tmp_variable("int64", shape=(-1,),
                                         stop_gradient=True)
        ins = self._decode_inputs(prompt)
        ins.update({"PromptLen": [prompt_len.name],
                    "PageTable": [page_table.name],
                    "KPool": [kpool.name], "VPool": [vpool.name]})
        helper.append_op(
            "paged_prefill", inputs=ins,
            outputs={"NextToken": [tok.name], "KPoolOut": [kpool.name],
                     "VPoolOut": [vpool.name]},
            attrs={"n_heads": self.n_heads, "page_size": int(page_size),
                   "eps": 1e-5})
        return tok

    def decode_step(self, cache, token, ctx_len, active, page_table,
                    page_size):
        """Append ONE paged decode step: feed `token` [B,1] (written into
        the cache at position ctx_len), attend over each slot's paged
        context, return the next greedy token [B] int64."""
        if self._params is None:
            raise RuntimeError("build the tower with .logits() first")
        kpool, vpool = cache
        helper = LayerHelper("paged_decode_step")
        tok = helper.create_tmp_variable("int64", shape=(-1,),
                                         stop_gradient=True)
        ins = self._decode_inputs(token)
        ins.update({"CtxLen": [ctx_len.name], "Active": [active.name],
                    "PageTable": [page_table.name],
                    "KPool": [kpool.name], "VPool": [vpool.name]})
        helper.append_op(
            "paged_decode_step", inputs=ins,
            outputs={"NextToken": [tok.name], "KPoolOut": [kpool.name],
                     "VPoolOut": [vpool.name]},
            attrs={"n_heads": self.n_heads, "page_size": int(page_size),
                   "eps": 1e-5})
        return tok

    def _decode_inputs(self, prompt):
        """Wire the recorded tower parameters into a decode op's slots,
        declaring them in the current program."""
        p = self._params
        gb = default_main_program().global_block()
        for v in p:
            if v.name not in gb.vars:
                gb.create_parameter(name=v.name, shape=v.shape,
                                    dtype=v.dtype)
        L = self.n_layers

        def per(off):
            return [p[2 + i * self._PER_LAYER + off].name for i in range(L)]

        return {"Tokens": [prompt.name], "Emb": [p[0].name],
                "Pos": [p[1].name],
                "Ln1S": per(0), "Ln1B": per(1), "WQ": per(2),
                "WK": per(3), "WV": per(4), "WO": per(5),
                "Ln2S": per(6), "Ln2B": per(7), "W1": per(8),
                "B1": per(9), "W2": per(10), "B2": per(11),
                "LnfS": [p[-3].name], "LnfB": [p[-2].name],
                "WHead": [p[-1].name]}
