"""Decoder-only transformer language model (GPT-style): the tower builder
``decoder_lm``, the loss ``lm_loss``, the training program
``build_lm_train_program``, and ``DecoderLM``'s generation (``generate``,
``beam_generate``) and paged serving path, ported from
``paddle_tpu/models/transformer.py``.

Architecture: pre-LN residual blocks (LN → causal MHA → +x; LN → MLP
gelu → +x), learned position embeddings, final LN, untied LM head.
"""

from __future__ import annotations

import contextlib

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
               mlp_ratio=4, dtype="float32", dropout_prob=0.0,
               is_test=False, remat=False, sp_mode="ring",
               sp_schedule="zigzag"):
    """tokens [B, T, 1] int64 → logits [B, T, vocab_size].

    The JAX signature.  `dropout_prob` > 0 puts a dropout after the
    embedding and after each attention and MLP branch; `remat=True` builds
    each layer inside ``layers.recompute``.  `sp_mode`/`sp_schedule` are
    recorded on the attention ops: one device, so the attention is the
    single-card flash kernel, as the JAX package picks without a mesh."""
    emb = layers.embedding(tokens, size=[vocab_size, dim], dtype=dtype)
    pos = _positions(tokens, dim, max_len, dtype)
    x = layers.elementwise_add(emb, pos, axis=1)
    if dropout_prob:
        x = layers.dropout(x, dropout_prob, is_test=is_test)

    blk = layers.recompute if remat else contextlib.nullcontext
    for _ in range(n_layers):
        with blk():
            h = layers.layer_norm(x, begin_norm_axis=2)
            a = layers.multi_head_attention(
                h, h, h, num_heads=n_heads, causal=True,
                sp_mode=sp_mode, sp_schedule=sp_schedule)
            if dropout_prob:
                a = layers.dropout(a, dropout_prob, is_test=is_test)
            x = layers.elementwise_add(x, a)
            h = layers.layer_norm(x, begin_norm_axis=2)
            m = layers.fc(h, dim * mlp_ratio, num_flatten_dims=2,
                          act="gelu")
            m = layers.fc(m, dim, num_flatten_dims=2)
            if dropout_prob:
                m = layers.dropout(m, dropout_prob, is_test=is_test)
            x = layers.elementwise_add(x, m)

    x = layers.layer_norm(x, begin_norm_axis=2)
    return layers.fc(x, vocab_size, num_flatten_dims=2, bias_attr=False)


def lm_loss(logits, targets, dtype="float32"):
    """Next-token loss: logits [B, T, V] vs targets [B, T, 1] (already
    shifted by the data pipeline).  Softmax runs in f32 regardless of the
    model compute dtype."""
    V = logits.shape[-1]
    flat = layers.reshape(logits, [-1, V])
    if dtype != "float32":
        flat = layers.cast(flat, "float32")
    tgt = layers.reshape(targets, [-1, 1])
    return layers.mean(layers.softmax_with_cross_entropy(flat, tgt))


class DecoderLM:
    """Decoder-only LM with generation and the paged serving path.

    `logits(tokens)` builds the tower via decoder_lm and RECORDS its
    parameters in creation order; the generation ops (`generate`,
    `beam_generate`) and the serving ops (`prefill`, `decode_step`) wire
    those same parameters into their slots, and the values are shared
    through the scope by name."""

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

    def logits(self, tokens, **kw):
        if self._params is not None:
            raise RuntimeError(
                "DecoderLM.logits() already built this model's tower — "
                "one instance owns one parameter set")
        block = default_main_program().global_block()
        before = set(block.vars)
        out = decoder_lm(tokens, self.vocab_size, self.dim, self.n_layers,
                         self.n_heads, self.max_len,
                         mlp_ratio=self.mlp_ratio, dtype=self.dtype, **kw)
        new = [v for n, v in block.vars.items()
               if n not in before and isinstance(v, Parameter)]
        want = 2 + self._PER_LAYER * self.n_layers + 3
        if len(new) != want:
            raise RuntimeError(f"tower created {len(new)} parameters, "
                               f"expected {want}")
        self._params = new
        return out

    def generate(self, prompt, max_gen, eos_id=-1, temperature=0.0,
                 top_k=0):
        """prompt [B, P, 1] int64 → Ids [B, max_gen] int64 (op
        ``gpt_decode``: K1 prefills the prompt, then max_gen - 1 cached
        steps).

        temperature=0 is greedy (``stable_argmax``); > 0 samples
        softmax(logits / temperature), optionally truncated to the top_k
        most likely tokens, from the run's (seed, step) stream, so each
        run draws afresh and the same (seed, step) replays.  Build it in
        its own program (``with fluid.program_guard(p):``); the
        parameters are shared with the tower through the scope by
        name."""
        if self._params is None:
            raise RuntimeError("build the tower with .logits() first")
        if top_k > self.vocab_size:
            raise ValueError(
                f"top_k={top_k} exceeds vocab_size={self.vocab_size}")
        self._check_len(prompt, max_gen)
        helper = LayerHelper("gpt_decode")
        ids = helper.create_tmp_variable("int64", shape=(-1, max_gen),
                                         stop_gradient=True)
        helper.append_op(
            "gpt_decode",
            inputs=self._decode_inputs(prompt),
            outputs={"Ids": [ids.name]},
            attrs={"n_heads": self.n_heads, "max_gen": int(max_gen),
                   "eos_id": int(eos_id), "eps": 1e-5,
                   "temperature": float(temperature), "top_k": int(top_k)},
        )
        return ids

    def beam_generate(self, prompt, max_gen, beam_size, eos_id=-1):
        """prompt [B, P, 1] int64 → (Ids [B, K, max_gen] int64, lanes best
        first; Scores [B, K] f32 accumulated log-probs) — op
        ``gpt_beam_decode``.  Same own-program, shared-scope contract as
        generate()."""
        if self._params is None:
            raise RuntimeError("build the tower with .logits() first")
        if not 1 <= beam_size <= self.vocab_size:
            raise ValueError(
                f"beam_size={beam_size} must be in [1, vocab_size="
                f"{self.vocab_size}] (top-k over the vocab seeds lanes)")
        self._check_len(prompt, max_gen)
        helper = LayerHelper("gpt_beam_decode")
        ids = helper.create_tmp_variable(
            "int64", shape=(-1, beam_size, max_gen), stop_gradient=True)
        scores = helper.create_tmp_variable(
            "float32", shape=(-1, beam_size), stop_gradient=True)
        helper.append_op(
            "gpt_beam_decode",
            inputs=self._decode_inputs(prompt),
            outputs={"Ids": [ids.name], "Scores": [scores.name]},
            attrs={"n_heads": self.n_heads, "max_gen": int(max_gen),
                   "beam_size": int(beam_size), "eos_id": int(eos_id),
                   "eps": 1e-5},
        )
        return ids, scores

    def _check_len(self, prompt, max_gen):
        P = prompt.shape[1]
        if P + max_gen > self.max_len:
            raise ValueError(f"prompt {P} + max_gen {max_gen} exceeds "
                             f"max_len={self.max_len}")

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

    def prefill_chunk(self, tokens, ctx_len, chunk_len, page_table, cache,
                      page_size, all_tokens=False):
        """Append one paged_prefill_chunk op: materialize K/V for `tokens`
        [K,C,1] at context offset `ctx_len` [K,1] through `page_table`,
        return the greedy token [K] at each lane's last valid position
        (meaningful on a lane's FINAL chunk; `chunk_len` [K,1] = 0 idles
        a lane).  ``all_tokens=True`` returns (tok, chunk_tokens) where
        chunk_tokens [K,C] is the greedy pick after EVERY position — the
        speculative verify step."""
        if self._params is None:
            raise RuntimeError("build the tower with .logits() first")
        kpool, vpool = cache
        helper = LayerHelper("paged_prefill_chunk")
        tok = helper.create_tmp_variable("int64", shape=(-1,),
                                         stop_gradient=True)
        ins = self._decode_inputs(tokens)
        ins.update({"CtxLen": [ctx_len.name], "ChunkLen": [chunk_len.name],
                    "PageTable": [page_table.name],
                    "KPool": [kpool.name], "VPool": [vpool.name]})
        outs = {"NextToken": [tok.name], "KPoolOut": [kpool.name],
                "VPoolOut": [vpool.name]}
        ctok = None
        if all_tokens:
            C = int(tokens.shape[-2])  # [.., C, 1] token payload
            ctok = helper.create_tmp_variable("int64", shape=(-1, C),
                                              stop_gradient=True)
            outs["ChunkTokens"] = [ctok.name]
        helper.append_op(
            "paged_prefill_chunk", inputs=ins, outputs=outs,
            attrs={"n_heads": self.n_heads, "page_size": int(page_size),
                   "eps": 1e-5, "all_tokens": int(bool(all_tokens))})
        if all_tokens:
            return tok, ctok
        return tok

    def spec_draft(self, cache, token, ctx_len, spec_len, page_table,
                   page_size, k_steps):
        """Append a paged_spec_draft op: `k_steps` chained greedy decode
        steps of THIS tower (the draft — see truncated()) over the
        target's pools, returning the drafted continuation [B, k_steps]
        int64.  `spec_len` [B,1] caps per-slot drafting (0 idles a
        slot)."""
        if self._params is None:
            raise RuntimeError("build the tower with .logits() first")
        kpool, vpool = cache
        helper = LayerHelper("paged_spec_draft")
        drafted = helper.create_tmp_variable(
            "int64", shape=(-1, int(k_steps)), stop_gradient=True)
        ins = self._decode_inputs(token)
        ins.update({"CtxLen": [ctx_len.name], "SpecLen": [spec_len.name],
                    "PageTable": [page_table.name],
                    "KPool": [kpool.name], "VPool": [vpool.name]})
        helper.append_op(
            "paged_spec_draft", inputs=ins,
            outputs={"Drafted": [drafted.name], "KPoolOut": [kpool.name],
                     "VPoolOut": [vpool.name]},
            attrs={"n_heads": self.n_heads, "page_size": int(page_size),
                   "eps": 1e-5, "k_steps": int(k_steps)})
        return drafted

    def truncated(self, n_layers):
        """A DEPTH-TRUNCATED view of this model: the first `n_layers`
        blocks plus the shared embedding/position/final-LN/head — the
        self-speculative DRAFT.  The view owns no parameters of its own
        (its _params alias this model's), so draft layer i computes
        exactly target layer i and the two towers share one KV pool (the
        draft touches only pool layers < n_layers).  Call it through
        ``serving.speculative.build_draft_lm``."""
        if self._params is None:
            raise RuntimeError("build the tower with .logits() first")
        if not 1 <= int(n_layers) <= self.n_layers:
            raise ValueError(
                f"draft depth {n_layers} not in [1, {self.n_layers}]")
        draft = DecoderLM(self.vocab_size, self.dim, int(n_layers),
                          self.n_heads, self.max_len,
                          mlp_ratio=self.mlp_ratio, dtype=self.dtype)
        head = 2 + self._PER_LAYER * int(n_layers)
        draft._params = self._params[:head] + self._params[-3:]
        return draft

    def page_copy(self, src, dst, cache):
        """Append a paged_page_copy op: physical page `src` [M,1] -> `dst`
        [M,1] across every layer of both pools (prefix-cache
        copy-on-write; unused lanes pass 0 -> 0, a null-page no-op).
        Returns the fetchable dst witness [M] int64."""
        kpool, vpool = cache
        helper = LayerHelper("paged_page_copy")
        out = helper.create_tmp_variable("int64", shape=(-1,),
                                         stop_gradient=True)
        helper.append_op(
            "paged_page_copy",
            inputs={"Src": [src.name], "Dst": [dst.name],
                    "KPool": [kpool.name], "VPool": [vpool.name]},
            outputs={"Out": [out.name], "KPoolOut": [kpool.name],
                     "VPoolOut": [vpool.name]},
            attrs={})
        return out

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


def build_lm_train_program(seq_len, vocab_size=32000, dim=512,
                           n_layers=8, n_heads=8, dtype="bfloat16",
                           learning_rate=3e-4, remat=False,
                           sp_mode="ring", sp_schedule="zigzag"):
    """Bench/test entry: data vars + decoder_lm + Adam; returns the loss
    var.  Feed 'tokens' and 'targets' as [B, T, 1] int64 — the batch dim
    is free."""
    from .. import optimizer as opt

    tokens = layers.data("tokens", shape=[seq_len, 1], dtype="int64")
    targets = layers.data("targets", shape=[seq_len, 1], dtype="int64")
    logits = decoder_lm(tokens, vocab_size, dim, n_layers, n_heads,
                        max_len=seq_len, dtype=dtype, remat=remat,
                        sp_mode=sp_mode, sp_schedule=sp_schedule)
    loss = lm_loss(logits, targets, dtype=dtype)
    opt.Adam(learning_rate=learning_rate).minimize(loss)
    return loss
