"""Evaluators that accumulate over minibatches, the port of
``paddle_tpu/evaluator.py``: ``Accuracy`` and ``ChunkEvaluator``.

Their state is int64 [1] persistable variables in the scope, zeroed by
the startup program and added to by ``sum`` ops inside the training
program, so counting costs the step nothing more on the card; ``eval``
reads the state on the host and ``reset`` zeroes it.  ``DetectionMAP``
accumulates ``detection_output`` slates and ground truth on the host, as
the reference's evaluator did, and ``eval`` gives their mAP."""

from __future__ import annotations

import numpy as np
import torch

from .framework import unique_name
from .framework.core import torch_dtype
from .framework.initializer import ConstantInitializer
from .framework.layer_helper import LayerHelper
from .framework.scope import global_scope


class Evaluator:
    def __init__(self, name):
        self.helper = LayerHelper(name)
        self.states = []
        self.metrics = []

    def _create_state(self, suffix, shape, dtype="float32"):
        var = self.helper.create_global_variable(
            name=unique_name.generate(f"{self.helper.name}_{suffix}"),
            shape=shape, dtype=dtype)
        self.helper.set_initialized(var, ConstantInitializer(0.0))
        self.states.append(var)
        return var

    def reset(self, executor, reset_program=None):
        scope = global_scope()
        for s in self.states:
            scope.set(s.name, torch.zeros(s.shape, dtype=torch_dtype(s.dtype)))

    def eval(self, executor):
        raise NotImplementedError

    def _count(self, state, batch):
        """state += batch, as a ``sum`` op of the program."""
        self.helper.block.append_op("sum",
                                    inputs={"X": [state.name, batch.name]},
                                    outputs={"Out": [state.name]})

    @staticmethod
    def _read(var):
        return float(global_scope().find_np(var.name).item())


class Accuracy(Evaluator):
    """Top-k accuracy over every minibatch seen since the last reset."""

    def __init__(self, input, label, k=1):
        super().__init__("accuracy")
        from . import layers

        self.total = self._create_state("total", (1,), "int64")
        self.correct = self._create_state("correct", (1,), "int64")
        _, indices = layers.topk(input, k)
        acc = self.helper.create_tmp_variable("float32", shape=(1,),
                                              stop_gradient=True)
        correct_b = self.helper.create_tmp_variable("int64", shape=(1,),
                                                    stop_gradient=True)
        total_b = self.helper.create_tmp_variable("int64", shape=(1,),
                                                  stop_gradient=True)
        self.helper.block.append_op(
            "accuracy",
            inputs={"Indices": [indices.name], "Label": [label.name]},
            outputs={"Accuracy": [acc.name], "Correct": [correct_b.name],
                     "Total": [total_b.name]})
        self._count(self.total, total_b)
        self._count(self.correct, correct_b)
        self.batch_acc = acc

    def eval(self, executor=None):
        return self._read(self.correct) / max(self._read(self.total), 1.0)


class ChunkEvaluator(Evaluator):
    """Chunk precision, recall and F1 over every minibatch seen since the
    last reset, from ``chunk_eval``'s per-batch counts of inferred,
    labelled and correct chunks."""

    def __init__(self, num_infer_chunks, num_label_chunks,
                 num_correct_chunks):
        super().__init__("chunk_evaluator")
        self.num_infer = self._create_state("num_infer", (1,), "int64")
        self.num_label = self._create_state("num_label", (1,), "int64")
        self.num_correct = self._create_state("num_correct", (1,), "int64")
        for state, batch in ((self.num_infer, num_infer_chunks),
                             (self.num_label, num_label_chunks),
                             (self.num_correct, num_correct_chunks)):
            self._count(state, batch)

    def eval(self, executor=None):
        infer, label, correct = (self._read(v) for v in (
            self.num_infer, self.num_label, self.num_correct))
        precision = correct / infer if infer else 0.0
        recall = correct / label if label else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if precision + recall else 0.0)
        return precision, recall, f1


class DetectionMAP:
    """Mean average precision over accumulated detections (the legacy
    detection_map evaluator, gserver/evaluators/DetectionMAPEvaluator.cpp).

    Host-side accumulator (evaluators were host C++ in the reference too):
    feed it, per batch, the static [N, K, 6] slate from `detection_output`
    ((label, score, x1, y1, x2, y2), label < 0 = padding) plus padded ground
    truth [N, G, 4], labels [N, G], counts [N].  `eval()` returns mAP using
    11-point or integral interpolation."""

    def __init__(self, overlap_threshold=0.5, ap_version="integral",
                 evaluate_difficult=False, background_label=None):
        self.overlap_threshold = float(overlap_threshold)
        self.ap_version = ap_version
        # VOC semantics: difficult gts count toward npos only when True;
        # when False a detection matching a difficult gt is neither TP nor FP
        self.evaluate_difficult = bool(evaluate_difficult)
        # class id excluded from scoring (the v1 evaluator's background_id)
        self.background_label = background_label
        self.reset()

    def reset(self, executor=None, reset_program=None):
        self._dets = []   # (img_id, cls, score, box)
        self._gts = []    # (img_id, cls, box, difficult)
        self._next_img = 0

    def add_batch(self, detections, gt_boxes, gt_labels, gt_counts,
                  gt_difficult=None):
        detections = np.asarray(detections)
        gt_boxes = np.asarray(gt_boxes)
        gt_labels = np.asarray(gt_labels)
        gt_counts = np.asarray(gt_counts).astype(int)
        for i in range(detections.shape[0]):
            img = self._next_img
            self._next_img += 1
            for row in detections[i]:
                if row[0] < 0:
                    continue
                self._dets.append((img, int(row[0]), float(row[1]),
                                   row[2:6].astype(float)))
            for g in range(gt_counts[i]):
                diff = bool(gt_difficult[i, g]) if gt_difficult is not None \
                    else False
                self._gts.append((img, int(gt_labels[i, g]),
                                  gt_boxes[i, g].astype(float), diff))

    @staticmethod
    def _iou(a, b):
        iw = max(min(a[2], b[2]) - max(a[0], b[0]), 0.0)
        ih = max(min(a[3], b[3]) - max(a[1], b[1]), 0.0)
        inter = iw * ih
        ua = max(a[2] - a[0], 0) * max(a[3] - a[1], 0)
        ub = max(b[2] - b[0], 0) * max(b[3] - b[1], 0)
        return inter / max(ua + ub - inter, 1e-10)

    def eval(self, executor=None):
        classes = sorted({c for _, c, *_ in self._gts
                          if c != self.background_label})
        aps = []
        for cls in classes:
            gts = [(img, box, diff) for img, c, box, diff in self._gts
                   if c == cls]
            dets = sorted((d for d in self._dets if d[1] == cls),
                          key=lambda d: -d[2])
            npos = sum(1 for _, _, diff in gts
                       if self.evaluate_difficult or not diff)
            matched = set()
            tp, fp = [], []
            for img, _, score, box in dets:
                # VOC protocol: match to the overall best-IoU gt; if that gt
                # is already taken the detection is a false positive (no
                # re-assignment to a lesser-overlap gt)
                best, best_j = 0.0, -1
                for j, (gimg, gbox, _) in enumerate(gts):
                    if gimg != img:
                        continue
                    o = self._iou(box, gbox)
                    if o > best:
                        best, best_j = o, j
                if best >= self.overlap_threshold and best_j >= 0:
                    if gts[best_j][2] and not self.evaluate_difficult:
                        continue  # difficult gt: ignore this detection
                    if best_j in matched:
                        tp.append(0.0)
                        fp.append(1.0)
                    else:
                        matched.add(best_j)
                        tp.append(1.0)
                        fp.append(0.0)
                else:
                    tp.append(0.0)
                    fp.append(1.0)
            if npos == 0:
                continue
            tp = np.cumsum(tp) if tp else np.array([])
            fp = np.cumsum(fp) if fp else np.array([])
            rec = tp / npos if len(tp) else np.array([0.0])
            prec = (tp / np.maximum(tp + fp, 1e-10)) if len(tp) \
                else np.array([0.0])
            if self.ap_version == "11point":
                ap = float(np.mean([
                    max([p for p, r in zip(prec, rec) if r >= t], default=0.0)
                    for t in np.linspace(0, 1, 11)]))
            else:  # integral (VOC-style all-points)
                mrec = np.concatenate([[0.0], rec, [1.0]])
                mpre = np.concatenate([[0.0], prec, [0.0]])
                for k in range(len(mpre) - 2, -1, -1):
                    mpre[k] = max(mpre[k], mpre[k + 1])
                idx = np.where(mrec[1:] != mrec[:-1])[0]
                ap = float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
            aps.append(ap)
        return float(np.mean(aps)) if aps else 0.0
