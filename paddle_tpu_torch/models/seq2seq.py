"""Attention NMT (seq2seq), the machine_translation book model — the
training half of ``paddle_tpu/models/seq2seq.py``.

Encoder: embedding → per-step fc → bidirectional GRU (``dynamic_gru``,
plain and reversed); decoder: Bahdanau-attention GRU
(``attention_gru_decoder``) trained teacher-forced.  ``encode``,
``_decoder_h0`` and ``train_cost`` emit the JAX package's program op for
op, so parameters carry across by name.  Beam-search generation
(``generate``, ``generate_composable``) is not ported yet."""

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
        raise NotImplementedError(
            "Seq2SeqAttention.generate (compiled beam search) is not ported "
            "yet: ROADMAP.md Queue A item 5")

    def generate_composable(self, src_words, beam_size=4, max_len=16):
        raise NotImplementedError(
            "Seq2SeqAttention.generate_composable (While + beam_search ops) "
            "is not ported yet: ROADMAP.md Queue A item 5")
