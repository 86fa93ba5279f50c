"""``stacked_lstm_net``, the one model of
``paddle_tpu/models/image_models.py`` that the port carries so far: the
stacked-LSTM text classifier of the repository's RNN benchmark."""

from __future__ import annotations

from .. import layers


def stacked_lstm_net(seq_input, hidden_dim=512, stacked_num=2, class_dim=2):
    """Stacked LSTM text classifier: per layer a per-step fc to 4H and a
    ``dynamic_lstm`` (odd layers run reversed), then a max pool over time
    and an fc to the classes."""
    inp = seq_input
    for i in range(stacked_num):
        proj = layers.sequence_fc(inp, size=hidden_dim * 4)
        hidden, _ = layers.dynamic_lstm(proj, size=hidden_dim * 4,
                                        is_reverse=(i % 2 == 1))
        inp = hidden
    pooled = layers.sequence_pool(inp, pool_type="max")
    return layers.fc(input=pooled, size=class_dim)
