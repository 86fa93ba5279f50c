"""The DeepFM CTR model, the port of ``paddle_tpu/models/deepfm.py``.

Inputs are field-wise categorical ids [B, num_fields]; the model is FM
(first order, and the pairwise interactions by the square-of-sum trick)
plus a deep MLP over the concatenated field embeddings.  ``sparse``
sets the embeddings' ``is_sparse`` attribute, which the ``lookup_table``
op carries; its gradient is dense in both packages."""

from __future__ import annotations

from .. import layers
from ..framework.layer_helper import LayerHelper


def deepfm(field_ids, num_fields, vocab_size, embed_dim=16,
           hidden_sizes=(64, 32), sparse=True):
    """field_ids: int64 data var [B, num_fields] (global ids per field).
    Returns CTR logit [B, 1]."""
    helper = LayerHelper("deepfm")

    # first-order weights: embedding of dim 1
    w1 = layers.embedding(field_ids, size=[vocab_size, 1], is_sparse=sparse,
                          param_attr={"name": "deepfm.w1"})
    # w1: [B, num_fields, 1] → sum over fields
    first_order = layers.reshape(w1, [-1, num_fields])
    fo = helper.create_tmp_variable("float32")
    helper.append_op("reduce_sum", inputs={"X": [first_order.name]},
                     outputs={"Out": [fo.name]},
                     attrs={"dim": 1, "keep_dim": True})

    # field embeddings [B, num_fields, K]
    emb = layers.embedding(field_ids, size=[vocab_size, embed_dim],
                           is_sparse=sparse,
                           param_attr={"name": "deepfm.emb"})

    # FM second order: 0.5 * sum_k[(sum_f e)^2 - sum_f e^2]
    sum_f = helper.create_tmp_variable("float32")
    helper.append_op("reduce_sum", inputs={"X": [emb.name]},
                     outputs={"Out": [sum_f.name]}, attrs={"dim": 1})
    sum_sq = helper.create_tmp_variable("float32")
    helper.append_op("square", inputs={"X": [sum_f.name]},
                     outputs={"Out": [sum_sq.name]})
    sq = helper.create_tmp_variable("float32")
    helper.append_op("square", inputs={"X": [emb.name]},
                     outputs={"Out": [sq.name]})
    sq_sum = helper.create_tmp_variable("float32")
    helper.append_op("reduce_sum", inputs={"X": [sq.name]},
                     outputs={"Out": [sq_sum.name]}, attrs={"dim": 1})
    diff = helper.create_tmp_variable("float32")
    helper.append_op("elementwise_sub",
                     inputs={"X": [sum_sq.name], "Y": [sq_sum.name]},
                     outputs={"Out": [diff.name]}, attrs={"axis": -1})
    second = helper.create_tmp_variable("float32")
    helper.append_op("reduce_sum", inputs={"X": [diff.name]},
                     outputs={"Out": [second.name]},
                     attrs={"dim": 1, "keep_dim": True})
    second = layers.scale(second, scale=0.5)

    # deep tower over flattened embeddings
    deep = layers.reshape(emb, [-1, num_fields * embed_dim])
    for h in hidden_sizes:
        deep = layers.fc(input=deep, size=h, act="relu")
    deep_out = layers.fc(input=deep, size=1)

    logit = layers.elementwise_add(layers.elementwise_add(fo, second),
                                   deep_out)
    return logit
