"""The two recurrent training programs at full width, and their feeds.

- The stacked-LSTM text classifier of ``bench.py``'s ``bench_lstm_train``:
  vocab 30000, hidden 512, two LSTM layers (the second reversed), a max
  pool and an fc to 2 classes, bf16 embedding with f32 logits, Adam 0.002;
  batch 64 x 96.
- The attention-NMT training program (``Seq2SeqAttention.train_cost``) at
  the PaddlePaddle book's machine_translation widths: both dictionaries
  30000, embedding, hidden and attention 512, f32, Adam; batch 64, source
  and target 64 long; and its generation programs (``generate``,
  ``generate_composable``) for beam search over a source batch.

``chip_smoke.py``, ``tools/profile_torch_train.py`` and the tests build
them here, so their numbers describe one workload.  These functions reset
nothing: call ``paddle_tpu_torch.reset()`` first for fresh programs.
"""

from __future__ import annotations

import numpy as np

LSTM_VOCAB, LSTM_HIDDEN, LSTM_LAYERS, LSTM_CLASSES = 30000, 512, 2, 2
LSTM_BS, LSTM_SEQ, LSTM_LR = 64, 96, 0.002
NMT_VOCAB, NMT_DIM = 30000, 512
NMT_BS, NMT_SEQ, NMT_LR = 64, 64, 0.001


def lstm_train_program(vocab=LSTM_VOCAB, hidden=LSTM_HIDDEN,
                       seq_len=LSTM_SEQ, dtype="bfloat16",
                       learning_rate=LSTM_LR, train=True):
    """Build the classifier into the default programs; returns the loss.
    With ``train=False`` no backward and no update is appended: the same
    forward program in test mode."""
    import paddle_tpu_torch as fluid

    from .image_models import stacked_lstm_net

    words = fluid.layers.sequence_data(name="words", shape=[1],
                                       dtype="int64", max_len=seq_len)
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    emb = fluid.layers.sequence_embedding(words, size=[vocab, hidden],
                                          dtype=dtype)
    logits = stacked_lstm_net(emb, hidden_dim=hidden,
                              stacked_num=LSTM_LAYERS,
                              class_dim=LSTM_CLASSES)
    logits32 = fluid.layers.cast(logits, "float32") \
        if dtype != "float32" else logits
    loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits32, label))
    if train:
        fluid.optimizer.Adam(learning_rate=learning_rate).minimize(loss)
    return loss


def lstm_feed(bs=LSTM_BS, seq_len=LSTM_SEQ, vocab=LSTM_VOCAB, ragged=False,
              seed=0):
    """The bench's batch from ``RandomState(seed)``: full-length rows, or
    with ``ragged`` lengths drawn in [1, seq_len] (one row keeps the full
    length) and the padding zeroed."""
    rng = np.random.RandomState(seed)
    words = rng.randint(0, vocab, (bs, seq_len, 1)).astype(np.int64)
    lengths = np.full((bs,), seq_len, dtype=np.int32)
    label = rng.randint(0, LSTM_CLASSES, (bs, 1)).astype(np.int64)
    if ragged:
        lengths = rng.randint(1, seq_len + 1, (bs,)).astype(np.int32)
        lengths[0] = seq_len
        words[np.arange(seq_len)[None, :] >= lengths[:, None]] = 0
    return {"words": words, "words@LENGTH": lengths, "label": label}


def nmt_train_program(vocab=NMT_VOCAB, dim=NMT_DIM, seq_len=NMT_SEQ,
                      learning_rate=NMT_LR):
    """Build ``Seq2SeqAttention.train_cost`` and Adam into the default
    programs; returns the loss."""
    import paddle_tpu_torch as fluid

    from .seq2seq import Seq2SeqAttention

    model = Seq2SeqAttention(vocab, vocab, emb_dim=dim, hidden=dim, attn=dim)
    src = fluid.layers.sequence_data("src", shape=[1], dtype="int64",
                                     max_len=seq_len)
    tgt = fluid.layers.sequence_data("tgt", shape=[1], dtype="int64",
                                     max_len=seq_len)
    nxt = fluid.layers.sequence_data("tgt_next", shape=[1], dtype="int64",
                                     max_len=seq_len)
    loss = model.train_cost(src, tgt, nxt)
    fluid.optimizer.Adam(learning_rate=learning_rate).minimize(loss)
    return loss


def nmt_generate_programs(vocab=NMT_VOCAB, dim=NMT_DIM, seq_len=NMT_SEQ,
                          beam_size=4, max_len=16):
    """``Seq2SeqAttention.generate`` into the default programs and
    ``generate_composable`` into a program of its own (the parameters are
    shared by name); returns (generate's (ids, scores, lengths), the
    composable program, its (ids, scores, lengths)).  Feed ``src`` and
    ``src@LENGTH`` as ``nmt_feed`` makes them."""
    import paddle_tpu_torch as fluid

    from .seq2seq import Seq2SeqAttention

    def build(which):
        model = Seq2SeqAttention(vocab, vocab, emb_dim=dim, hidden=dim,
                                 attn=dim)
        src = fluid.layers.sequence_data("src", shape=[1], dtype="int64",
                                         max_len=seq_len)
        return getattr(model, which)(src, beam_size=beam_size,
                                     max_len=max_len)

    gen = build("generate")
    comp_prog = fluid.Program()
    with fluid.program_guard(comp_prog):
        comp = build("generate_composable")
    return gen, comp_prog, comp


def nmt_feed(bs=NMT_BS, seq_len=NMT_SEQ, vocab=NMT_VOCAB, seed=0):
    """A padded batch with ragged source and target lengths from
    ``RandomState(seed)`` (one row of each keeps the full length): tgt is
    <bos> + sentence, tgt_next the sentence + <eos>."""
    rng = np.random.RandomState(seed)
    steps = np.arange(seq_len)[None, :]

    def ragged():
        lengths = rng.randint(1, seq_len + 1, (bs,)).astype(np.int32)
        lengths[0] = seq_len
        return lengths

    src_len, tgt_len = ragged(), ragged()
    src = rng.randint(2, vocab, (bs, seq_len, 1)).astype(np.int64)
    sent = rng.randint(2, vocab, (bs, seq_len)).astype(np.int64)
    tgt = np.concatenate([np.zeros((bs, 1), np.int64), sent[:, :-1]], axis=1)
    nxt = sent.copy()
    nxt[np.arange(bs), tgt_len - 1] = 1  # <eos> closes each sentence
    src[steps >= src_len[:, None]] = 0
    tgt[steps >= tgt_len[:, None]] = 0
    nxt[steps >= tgt_len[:, None]] = 0
    return {"src": src, "src@LENGTH": src_len,
            "tgt": tgt[..., None], "tgt@LENGTH": tgt_len,
            "tgt_next": nxt[..., None], "tgt_next@LENGTH": tgt_len}
