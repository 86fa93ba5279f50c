"""Attention NMT (seq2seq), the machine_translation book model, ported
from ``paddle_tpu/models/seq2seq.py``.

Encoder: embedding → per-step fc → bidirectional GRU (``dynamic_gru``,
plain and reversed); decoder: Bahdanau-attention GRU
(``attention_gru_decoder``) trained teacher-forced; generation: beam
search in one op (``generate``) or composed from ``While``, the decoder
step and the beam ops (``generate_composable``).  Every method emits
the JAX package's ops, so parameters carry across by name;
``generate_composable`` shapes its decoder-step vars, where the JAX
package's leaves them unshaped and fails to build."""

from __future__ import annotations

from .. import layers
from ..framework.core import default_main_program
from ..framework.layer_helper import LayerHelper


class Seq2SeqAttention:
    def __init__(self, src_vocab, tgt_vocab, emb_dim=64, hidden=64, attn=64,
                 bos_id=0, eos_id=1, dtype="float32"):
        self.src_vocab = src_vocab
        self.tgt_vocab = tgt_vocab
        self.emb_dim = emb_dim
        self.hidden = hidden
        self.attn = attn
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.dtype = dtype
        self._helper = LayerHelper("seq2seq")
        self._make_decoder_params()

    # ------------------------------------------------------------------
    def _make_decoder_params(self):
        h, e, d, a = self.hidden, 2 * self.hidden, self.emb_dim, self.attn
        hp = self._helper

        def param(name, shape, is_bias=False):
            return hp.create_parameter(attr={"name": f"s2s.{name}"},
                                       shape=shape, dtype=self.dtype,
                                       is_bias=is_bias)

        self.w_in = param("dec_w_in", [d + e, 3 * h])
        self.b_in = param("dec_b_in", [3 * h], is_bias=True)
        self.w_h = param("dec_w_h", [h, 3 * h])
        self.w_q = param("attn_w_q", [h, a])
        self.w_m = param("attn_w_m", [e, a])
        self.v = param("attn_v", [a])
        self.w_out = param("dec_w_out", [h, self.tgt_vocab])
        self.b_out = param("dec_b_out", [self.tgt_vocab], is_bias=True)
        self.w_h0 = param("dec_w_h0", [e, h])
        # target embedding is shared between teacher forcing and generation
        self.tgt_emb = param("tgt_emb", [self.tgt_vocab, d])

    # ------------------------------------------------------------------
    def encode(self, src_words):
        """src_words: sequence_data of int64 ids → enc_out [B,Ts,2H]."""
        emb = layers.sequence_embedding(
            src_words, size=[self.src_vocab, self.emb_dim],
            param_attr={"name": "s2s.src_emb"}, dtype=self.dtype)
        proj = layers.sequence_fc(emb, size=3 * self.hidden,
                                  param_attr={"name": "s2s.enc_fc_f.w"},
                                  bias_attr={"name": "s2s.enc_fc_f.b"})
        fwd = layers.dynamic_gru(proj, size=self.hidden,
                                 param_attr={"name": "s2s.enc_gru_f.w"},
                                 bias_attr={"name": "s2s.enc_gru_f.b"})
        proj_b = layers.sequence_fc(emb, size=3 * self.hidden,
                                    param_attr={"name": "s2s.enc_fc_b.w"},
                                    bias_attr={"name": "s2s.enc_fc_b.b"})
        bwd = layers.dynamic_gru(proj_b, size=self.hidden, is_reverse=True,
                                 param_attr={"name": "s2s.enc_gru_b.w"},
                                 bias_attr={"name": "s2s.enc_gru_b.b"})
        enc = layers.concat([fwd, bwd], axis=2)
        layers.propagate_length(fwd, enc)
        return enc

    def _decoder_h0(self, enc_out):
        """Initial decoder state from the encoder's first backward state ~
        mean pooling here (static-shape friendly)."""
        hp = self._helper
        pooled = layers.sequence_pool(enc_out, pool_type="average")  # [B,2H]
        h0 = hp.create_tmp_variable(self.dtype,
                                    shape=(pooled.shape[0], self.hidden))
        hp.append_op("mul",
                     inputs={"X": [pooled.name], "Y": [self.w_h0.name]},
                     outputs={"Out": [h0.name]},
                     attrs={"x_num_col_dims": 1, "y_num_col_dims": 1})
        act = hp.create_tmp_variable(self.dtype, shape=h0.shape)
        hp.append_op("tanh", inputs={"X": [h0.name]},
                     outputs={"Out": [act.name]})
        return act

    # ------------------------------------------------------------------
    def train_cost(self, src_words, tgt_words, tgt_next_words):
        """Teacher-forced per-token CE, masked by target length.

        tgt_words = <bos> + sentence; tgt_next_words = sentence + <eos>."""
        hp = self._helper
        enc = self.encode(src_words)
        enc_len = layers.get_length_var(enc)
        tgt_emb = layers.sequence_embedding(
            tgt_words, size=[self.tgt_vocab, self.emb_dim],
            param_attr={"name": "s2s.tgt_emb"}, dtype=self.dtype)
        tgt_len = layers.get_length_var(tgt_emb)
        h0 = self._decoder_h0(enc)

        hidden = hp.create_tmp_variable(self.dtype)
        context = hp.create_tmp_variable(self.dtype)
        hp.append_op(
            "attention_gru_decoder",
            inputs={"EncOut": [enc.name], "EncLength": [enc_len.name],
                    "TgtEmb": [tgt_emb.name], "TgtLength": [tgt_len.name],
                    "H0": [h0.name], "WIn": [self.w_in.name],
                    "BIn": [self.b_in.name], "WH": [self.w_h.name],
                    "WQuery": [self.w_q.name], "WMem": [self.w_m.name],
                    "V": [self.v.name]},
            outputs={"Hidden": [hidden.name], "Context": [context.name]},
        )
        layers.propagate_length(tgt_emb, hidden)
        logits = hp.create_tmp_variable(self.dtype)
        hp.append_op("mul",
                     inputs={"X": [hidden.name], "Y": [self.w_out.name]},
                     outputs={"Out": [logits.name]},
                     attrs={"x_num_col_dims": 2, "y_num_col_dims": 1})
        logits_b = hp.create_tmp_variable(self.dtype)
        hp.append_op("elementwise_add",
                     inputs={"X": [logits.name], "Y": [self.b_out.name]},
                     outputs={"Out": [logits_b.name]}, attrs={"axis": 2})
        # per-token loss [B,Tt,1], masked mean over true tokens
        tok_loss = hp.create_tmp_variable(self.dtype)
        sm = hp.create_tmp_variable(self.dtype)
        hp.append_op(
            "softmax_with_cross_entropy",
            inputs={"Logits": [logits_b.name],
                    "Label": [tgt_next_words.name]},
            outputs={"Loss": [tok_loss.name], "Softmax": [sm.name]},
            attrs={"soft_label": False},
        )
        masked = hp.create_tmp_variable(self.dtype)
        hp.append_op(
            "masked_seq_mean",
            inputs={"X": [tok_loss.name], "Length": [tgt_len.name]},
            outputs={"Out": [masked.name]},
        )
        return default_main_program().global_block().var(masked.name)

    # ------------------------------------------------------------------
    def generate(self, src_words, beam_size=4, max_len=16):
        """Beam search in one op (``beam_search_generate``) → (ids
        [B,K,L] int32, scores [B,K], lengths [B,K] int32).  The encoder's
        two ``dynamic_gru`` ops launch K9 once each."""
        hp = self._helper
        enc = self.encode(src_words)
        enc_len = layers.get_length_var(enc)
        h0 = self._decoder_h0(enc)
        ids = hp.create_tmp_variable("int32", stop_gradient=True)
        scores = hp.create_tmp_variable(self.dtype, stop_gradient=True)
        lengths = hp.create_tmp_variable("int32", stop_gradient=True)
        hp.append_op(
            "beam_search_generate",
            inputs={"EncOut": [enc.name], "EncLength": [enc_len.name],
                    "Embedding": [self.tgt_emb.name], "H0": [h0.name],
                    "WIn": [self.w_in.name], "BIn": [self.b_in.name],
                    "WH": [self.w_h.name], "WQuery": [self.w_q.name],
                    "WMem": [self.w_m.name], "V": [self.v.name],
                    "WOut": [self.w_out.name], "BOut": [self.b_out.name]},
            outputs={"Ids": [ids.name], "Scores": [scores.name],
                     "Lengths": [lengths.name]},
            attrs={"beam_size": beam_size, "max_len": max_len,
                   "bos_id": self.bos_id, "eos_id": self.eos_id},
        )
        return ids, scores, lengths

    # ------------------------------------------------------------------
    def generate_composable(self, src_words, beam_size=4, max_len=16):
        """Generation from the composable ops, as fluid's
        test_machine_translation composes them: a ``While`` block runs
        the decoder step (``attention_gru_cell``, an ordinary op any user
        decoder can replace), ``topk``, the generic ``beam_search`` and
        ``beam_gather``, and ``array_write``s each step's selections;
        ``beam_search_decode`` backtracks them.

        Returns (ids [B,K,L] int64, scores [B,K], lengths [B,K] int32):
        ``generate``'s ids and scores (a lane's top-K per step holds the
        global top-K), and lengths that stop before the first eos, where
        ``generate``'s count it."""
        hp = self._helper
        K, L = int(beam_size), int(max_len)
        enc = self.encode(src_words)
        enc_len = layers.get_length_var(enc)
        h0 = self._decoder_h0(enc)  # [B,H]

        def batch_like(shape, value, dtype, out_idx):
            out = hp.create_tmp_variable(dtype, shape=tuple(shape),
                                         stop_gradient=True)
            hp.append_op(
                "fill_constant_batch_size_like",
                inputs={"Input": [h0.name]}, outputs={"Out": [out.name]},
                attrs={"shape": list(shape), "value": value, "dtype": dtype,
                       "input_dim_idx": 0, "output_dim_idx": out_idx})
            return out

        # beam state: h [B,K,H] broadcast from h0; tokens start at <bos>;
        # lane 0 live, the others dead (identical lanes would waste the
        # beam)
        h3 = hp.create_tmp_variable(self.dtype, shape=(-1, K, self.hidden),
                                    stop_gradient=True)
        hp.append_op("unsqueeze", inputs={"X": [h0.name]},
                     outputs={"Out": [h3.name]}, attrs={"axes": [1]})
        zeros_k = batch_like([-1, K], 0.0, "float32", 0)
        h = layers.elementwise_add(h3, layers.reshape(
            layers.fill_constant([K, 1], self.dtype, 0.0), [1, K, 1]))
        tokens = batch_like([-1, K], float(self.bos_id), "int64", 0)
        lane_dead = hp.create_tmp_variable("float32", shape=(1, K),
                                           stop_gradient=True)
        hp.append_op("assign_value", inputs={},
                     outputs={"Out": [lane_dead.name]},
                     attrs={"shape": [1, K],
                            "fp32_values": [0.0] + [-1e9] * (K - 1)})
        scores = layers.elementwise_add(zeros_k, lane_dead)

        ids_arr = batch_like([L, -1, K], 0.0, "int64", 1)
        par_arr = batch_like([L, -1, K], 0.0, "int32", 1)

        t = layers.fill_constant(shape=[1], dtype="float32", value=0.0)
        n = layers.fill_constant(shape=[1], dtype="float32", value=float(L))
        ti = layers.fill_constant(shape=[1], dtype="int32", value=0)
        cond = layers.less_than(t, n)
        w = layers.While(cond)
        with w.block():
            # shaped, unlike the JAX package's vars (shape None there,
            # on which layers.topk fails): topk reads the lane dims
            h_new = hp.create_tmp_variable(
                self.dtype, shape=(-1, K, self.hidden), stop_gradient=True)
            logp = hp.create_tmp_variable(
                self.dtype, shape=(-1, K, self.tgt_vocab),
                stop_gradient=True)
            hp.append_op(
                "attention_gru_cell",
                inputs={"EncOut": [enc.name], "EncLength": [enc_len.name],
                        "H": [h.name], "Tokens": [tokens.name],
                        "Embedding": [self.tgt_emb.name],
                        "WIn": [self.w_in.name], "BIn": [self.b_in.name],
                        "WH": [self.w_h.name], "WQuery": [self.w_q.name],
                        "WMem": [self.w_m.name], "V": [self.v.name],
                        "WOut": [self.w_out.name],
                        "BOut": [self.b_out.name]},
                outputs={"HNew": [h_new.name], "Logp": [logp.name]})
            # candidate pruning as the fluid loop: top-K of the step
            # distribution, then the generic beam_search op
            cand_scores, cand_ids = layers.topk(logp, K)
            sel_ids, sel_scores, parent = layers.beam_search(
                tokens, scores, cand_ids, cand_scores,
                beam_size=K, end_id=self.eos_id, is_accumulated=False)
            # reorder the decoder state by surviving parents
            h_sel = hp.create_tmp_variable(self.dtype, shape=None,
                                           stop_gradient=True)
            hp.append_op("beam_gather",
                         inputs={"X": [h_new.name], "Index": [parent.name]},
                         outputs={"Out": [h_sel.name]})
            # record the step
            ids_w = hp.create_tmp_variable("int64", shape=None,
                                           stop_gradient=True)
            hp.append_op("array_write",
                         inputs={"Array": [ids_arr.name],
                                 "X": [sel_ids.name], "I": [ti.name]},
                         outputs={"Out": [ids_w.name]})
            par_w = hp.create_tmp_variable("int32", shape=None,
                                           stop_gradient=True)
            hp.append_op("array_write",
                         inputs={"Array": [par_arr.name],
                                 "X": [parent.name], "I": [ti.name]},
                         outputs={"Out": [par_w.name]})
            layers.assign(ids_w, ids_arr)
            layers.assign(par_w, par_arr)
            layers.assign(h_sel, h)
            layers.assign(sel_ids, tokens)
            layers.assign(sel_scores, scores)
            layers.increment(t, 1.0)
            layers.increment(ti, 1)
            layers.less_than(t, n, cond=cond)

        sent, sscores, slen = layers.beam_search_decode(
            ids_arr, par_arr, scores, end_id=self.eos_id)
        return sent, sscores, slen
