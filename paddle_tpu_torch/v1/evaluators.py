"""v1 evaluator functions (reference trainer_config_helpers/evaluators.py:
classification_error, auc, pnpair, precision_recall, ctc_error, chunk).

Each appends the corresponding metric op to the current program and returns
the metric variable(s) to fetch — evaluators are graph pieces, as in the
reference (SURVEY.md §5 'evaluators as first-class graph pieces')."""

from __future__ import annotations

from ..framework.layer_helper import LayerHelper
from .layers import get_length_var
from .layers import _var


def classification_error_evaluator(input, label, name=None, top_k=1):
    """error rate = 1 - accuracy (evaluators.py classification_error)."""
    from .. import layers as fl

    acc = fl.accuracy(_var(input), _var(label), k=top_k)
    return fl.scale(acc, scale=-1.0, bias=1.0)


def auc_evaluator(input, label, name=None):
    from .. import layers as fl

    return fl.auc(_var(input), _var(label))


def precision_recall_evaluator(input, label, class_number, name=None):
    from .. import layers as fl

    helper = LayerHelper("precision_recall")
    _, idx = fl.topk(_var(input), 1)
    batch = helper.create_tmp_variable("float32", shape=(3,))
    accum = helper.create_tmp_variable("float32", shape=(3,))
    helper.append_op(
        "precision_recall",
        inputs={"Indices": [idx.name], "Label": [_var(label).name]},
        outputs={"BatchMetrics": [batch.name], "AccumMetrics": [accum.name]},
        attrs={"class_number": int(class_number)})
    return batch


def pnpair_evaluator(input, label, query_id, name=None):
    helper = LayerHelper("pnpair")
    outs = [helper.create_tmp_variable("float32", shape=(1,))
            for _ in range(3)]
    helper.append_op(
        "positive_negative_pair",
        inputs={"Score": [_var(input).name], "Label": [_var(label).name],
                "QueryID": [_var(query_id).name]},
        outputs={"PositivePair": [outs[0].name],
                 "NegativePair": [outs[1].name],
                 "NeutralPair": [outs[2].name]})
    return tuple(outs)


def chunk_evaluator(input, label, chunk_scheme, num_chunk_types, name=None):
    helper = LayerHelper("chunk_eval")
    iv, lv = _var(input), _var(label)
    length = get_length_var(iv) or get_length_var(lv)
    outs = {s: helper.create_tmp_variable(
        "float32" if i < 3 else "int64", shape=(1,))
        for i, s in enumerate(["Precision", "Recall", "F1-Score",
                               "NumInferChunks", "NumLabelChunks",
                               "NumCorrectChunks"])}
    helper.append_op(
        "chunk_eval",
        inputs={"Inference": [iv.name], "Label": [lv.name],
                "Length": [length.name if length is not None else ""]},
        outputs={k: [v.name] for k, v in outs.items()},
        attrs={"num_chunk_types": int(num_chunk_types),
               "chunk_scheme": chunk_scheme})
    return outs["Precision"], outs["Recall"], outs["F1-Score"]


def ctc_error_evaluator(input, label, name=None):
    """Sequence edit-distance rate (evaluators.py ctc_error)."""
    helper = LayerHelper("edit_distance")
    iv, lv = _var(input), _var(label)
    hyp_len = get_length_var(iv)
    ref_len = get_length_var(lv)
    dist = helper.create_tmp_variable("float32", shape=(0,))
    seqn = helper.create_tmp_variable("int64", shape=(1,))
    helper.append_op(
        "edit_distance",
        inputs={"Hyps": [iv.name], "Refs": [lv.name],
                "HypsLength": [hyp_len.name], "RefsLength": [ref_len.name]},
        outputs={"Out": [dist.name], "SequenceNum": [seqn.name]},
        attrs={"normalized": True})
    return dist


def detection_map_evaluator(input=None, label=None, background_id=0,
                            overlap_threshold=0.5, ap_version="integral",
                            evaluate_difficult=False, name=None, **kw):
    """Detection mAP (reference evaluators.py detection_map_evaluator).

    Evaluators were host-side C++ accumulators in the reference; the fluid
    DetectionMAP here is the same shape: feed each batch's fetched
    `detection_output` slate + ground truth via `.add_batch(...)`, read
    `.eval()`.  The graph inputs are accepted for config-API parity."""
    from ..evaluator import DetectionMAP

    return DetectionMAP(overlap_threshold=overlap_threshold,
                        ap_version=ap_version,
                        evaluate_difficult=evaluate_difficult,
                        background_label=background_id)


def sum_evaluator(input, name=None):
    """Sum of the input over the batch (evaluators.py sum_evaluator)."""
    from .. import layers as fl

    return fl.reduce_sum(_var(input), dim=None)


def column_sum_evaluator(input, name=None):
    """Per-column sum over the batch (evaluators.py column_sum_evaluator)."""
    from .. import layers as fl

    return fl.reduce_sum(_var(input), dim=0)


# --- printer evaluators (reference evaluators.py *_printer_evaluator):
# runtime prints from inside the compiled program via the print op ---------

def _print_on(var, message):
    from ..framework.layer_helper import LayerHelper

    helper = LayerHelper("print_eval")
    out = helper.create_tmp_variable(var.dtype, shape=var.shape)
    helper.append_op("print", inputs={"X": [var.name]},
                     outputs={"Out": [out.name]},
                     attrs={"message": message})
    return out


def value_printer_evaluator(input, name=None):
    v = _var(input)
    return _print_on(v, f"{name or v.name}: ")


def maxid_printer_evaluator(input, num_results=1, name=None):
    """Print the arg-max ids of each row (maxid_printer)."""
    from .. import layers as fl

    v = _var(input)
    _, idx = fl.topk(v, k=num_results)
    return _print_on(idx, f"{name or v.name} maxid: ")


def seqtext_printer_evaluator(input, result_file=None, name=None):
    """Print id sequences (seqtext_printer; file redirection is the
    caller's stdout redirect here — prints ride the compiled program)."""
    v = _var(input)
    return _print_on(v, f"{name or v.name} seq: ")


def classification_error_printer_evaluator(input, label, name=None):
    err = classification_error_evaluator(input, label)
    return _print_on(err, f"{name or 'classification_error'}: ")


def gradient_printer_evaluator(input, name=None):
    """Tag the var so append_backward prints its materialized gradient
    (reference gradient_printer_evaluator)."""
    v = _var(input)
    v.print_gradient = True
    return v
