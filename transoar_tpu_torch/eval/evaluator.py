"""Detection evaluation: COCO/nnDetection-style greedy matching + AP (copy
of ``transoar_tpu/eval/evaluator.py``; the tests pin it to the original).

Host-side (numpy) re-implementation of the protocol in reference
``transoar/evaluator.py`` + ``transoar/metric.py`` (both adapted from
pycocotools / nnDetection). Evaluation is offline bookkeeping — it stays on
host; only the per-image IoU matrix is vectorized numpy.

Protocol (must match the reference bit-for-bit, see BASELINE.md):
- class ids are shifted to 0-based on entry (evaluator.py:103-104);
- ``max_detections=1`` per class (evaluator.py:24,51);
- IoU threshold set = {0.1, 0.5, 0.75} ∪ coco 0.5:0.95:0.05 ∪ nndet
  0.1:0.5:0.05 (metric.py:45-61), matched greedily per image and class,
  detections visited in descending score order, each GT matched at most once
  (evaluator.py:393-422);
- 101-point recall interpolation with box-smoothed precision curve
  (metric.py:75, 438-452);
- ``mAP_coco`` averages precision over the coco IoU range, all classes,
  including classes that never appear (zeros, metric.py:347);
- subset scores (s/m/l) restrict the class axis (metric.py:142-148).
"""

from __future__ import annotations

import numpy as np

from transoar_tpu_torch.utils.boxes import box_iou_np


def match_image_class(pred_boxes, pred_scores, gt_boxes, gt_ignore,
                      iou_thresholds, max_detections):
    """Greedy COCO matching for one image + class.

    Returns dict with dtMatches/gtMatches/dtScores/gtIgnore/dtIgnore in the
    pycocotools layout ([T, D] / [T, G] arrays).
    """
    T = len(iou_thresholds)
    D = len(pred_scores)
    G = len(gt_boxes)

    if D == 0:
        return {
            "dtMatches": np.zeros((T, 0)),
            "gtMatches": np.zeros((T, G)),
            "dtScores": np.zeros((0,)),
            "gtIgnore": np.asarray(gt_ignore, float).reshape(-1),
            "dtIgnore": np.zeros((T, 0)),
        }

    order = np.argsort(-pred_scores, kind="mergesort")[:max_detections]
    pred_boxes = pred_boxes[order]
    pred_scores = pred_scores[order]
    D = len(pred_scores)

    if G == 0:
        return {
            "dtMatches": np.zeros((T, D)),
            "gtMatches": np.zeros((T, 0)),
            "dtScores": pred_scores,
            "gtIgnore": np.zeros((0,)),
            "dtIgnore": np.zeros((T, D)),
        }

    # Ignored GT sorted last (evaluator.py:381-383).
    g_order = np.argsort(gt_ignore, kind="mergesort")
    gt_boxes = gt_boxes[g_order]
    gt_ignore = np.asarray(gt_ignore, float)[g_order]

    ious = box_iou_np(pred_boxes, gt_boxes, box_format="cxcyczwhd")

    dt_match = np.zeros((T, D))
    gt_match = np.zeros((T, G))
    dt_ignore = np.zeros((T, D))
    for t_idx, threshold in enumerate(iou_thresholds):
        for d in range(D):
            best_iou = min(threshold, 1 - 1e-10)
            best_g = -1
            for g in range(G):
                if gt_match[t_idx, g] > 0:
                    continue
                # once matched to a real GT, don't trade for an ignored one
                if best_g > -1 and gt_ignore[best_g] == 0 and gt_ignore[g] == 1:
                    break
                if ious[d, g] < best_iou:
                    continue
                best_iou = ious[d, g]
                best_g = g
            if best_g >= 0:
                dt_ignore[t_idx, d] = gt_ignore[best_g]
                dt_match[t_idx, d] = 1
                gt_match[t_idx, best_g] = 1

    return {
        "dtMatches": dt_match,
        "gtMatches": gt_match,
        "dtScores": pred_scores,
        "gtIgnore": gt_ignore.reshape(-1),
        "dtIgnore": dt_ignore,
    }


def interpolated_precision(tp_cum, fp_cum, scores_sorted, recall_thresholds,
                           num_gt):
    """Recall + box-smoothed precision at the recall thresholds
    (reference metric.py:395-454)."""
    rc = tp_cum / num_gt
    pr = tp_cum / (fp_cum + tp_cum + np.spacing(1))

    recall = rc[-1] if len(tp_cum) else 0.0

    # Smooth precision into a monotone "box" curve.
    if len(pr):
        pr = np.maximum.accumulate(pr[::-1])[::-1]

    num_r = len(recall_thresholds)
    precision = np.zeros(num_r)
    th_scores = np.zeros(num_r)
    inds = np.searchsorted(rc, recall_thresholds, side="left")
    valid = inds < len(pr)
    precision[valid] = pr[inds[valid]]
    th_scores[valid] = scores_sorted[inds[valid]]
    return recall, precision, th_scores


class DetectionEvaluator:
    """Accumulates per-image matchings and computes the mAP family
    (reference DetectionEvaluator + Metric)."""

    def __init__(self, classes, classes_small, classes_mid, classes_large,
                 iou_range_coco=(0.5, 0.95, 0.05),
                 iou_range_nndet=(0.1, 0.5, 0.05),
                 iou_list=(0.1, 0.5, 0.75),
                 max_detections=1, per_class=False):
        self.classes = list(classes)
        self.subsets = {"s": classes_small, "m": classes_mid,
                        "l": classes_large}
        self.max_detections = max_detections
        self.per_class = per_class

        def _range(spec):
            start, stop, step = spec
            n = int(np.round((stop - start) / step)) + 1
            return np.linspace(start, stop, n, endpoint=True).round(2)

        iou_list = np.asarray(iou_list).round(2)
        self._coco = _range(iou_range_coco)
        self._nndet = _range(iou_range_nndet)
        self.iou_thresholds = np.union1d(
            np.union1d(iou_list, self._coco), self._nndet)
        self._iou_list = iou_list
        self.recall_thresholds = np.linspace(0.0, 1.0, 101, endpoint=True)

        self.results = []  # list over images of {class: matching dict}

    def _iou_idx(self, values):
        return np.nonzero(
            np.asarray(values)[:, None] == self.iou_thresholds[None])[1]

    def reset(self):
        self.results = []

    def add(self, pred_boxes, pred_classes, pred_scores, gt_boxes, gt_classes,
            gt_ignore=None):
        """Add one batch (lists over images). Class ids are 1-based on entry
        and shifted to 0-based here (evaluator.py:103-104)."""
        for i in range(len(pred_boxes)):
            pc = np.asarray(pred_classes[i]) - 1
            gc = np.asarray(gt_classes[i]) - 1
            pb = np.asarray(pred_boxes[i], float).reshape(-1, 6)
            gb = np.asarray(gt_boxes[i], float).reshape(-1, 6)
            ps = np.asarray(pred_scores[i], float).reshape(-1)
            gi = (np.zeros(len(gb)) if gt_ignore is None
                  else np.asarray(gt_ignore[i], float))

            record = {}
            for c in np.union1d(pc, gc):
                record[int(c)] = match_image_class(
                    pb[pc == c], ps[pc == c], gb[gc == c], gi[gc == c],
                    self.iou_thresholds, self.max_detections)
            self.results.append(record)

    def _statistics(self):
        """precision [T, R, C] and recall [T, C] arrays
        (reference metric.py:315-393, with the single max_detections)."""
        T = len(self.iou_thresholds)
        R = len(self.recall_thresholds)
        C = len(self.classes)
        precision = np.zeros((T, R, C))
        recall = np.zeros((T, C))
        scores = np.zeros((T, R, C))

        for c in range(C):
            recs = [r[c] for r in self.results if c in r]
            if not recs:
                continue
            dt_scores = np.concatenate(
                [r["dtScores"][: self.max_detections] for r in recs])
            order = np.argsort(-dt_scores, kind="mergesort")
            dt_scores = dt_scores[order]
            dt_m = np.concatenate(
                [r["dtMatches"][:, : self.max_detections] for r in recs],
                axis=1)[:, order]
            dt_ig = np.concatenate(
                [r["dtIgnore"][:, : self.max_detections] for r in recs],
                axis=1)[:, order]
            gt_ig = np.concatenate([r["gtIgnore"] for r in recs])
            num_gt = np.count_nonzero(gt_ig == 0)
            if num_gt == 0:
                continue

            tps = np.logical_and(dt_m, np.logical_not(dt_ig))
            fps = np.logical_and(np.logical_not(dt_m), np.logical_not(dt_ig))
            tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
            fp_cum = np.cumsum(fps, axis=1).astype(np.float64)

            for t in range(T):
                r_, p_, s_ = interpolated_precision(
                    tp_cum[t], fp_cum[t], dt_scores, self.recall_thresholds,
                    num_gt)
                recall[t, c] = r_
                precision[t, :, c] = p_
                scores[t, :, c] = s_
        return precision, recall, scores

    def eval(self):
        precision, recall, _ = self._statistics()

        def ap(iou_idx, cls_idx=None):
            p = precision[iou_idx]
            if cls_idx is not None:
                p = p[..., cls_idx]
            return float(np.mean(p))

        coco_idx = self._iou_idx(self._coco)
        nndet_idx = self._iou_idx(self._nndet)

        out = {
            "mAP_coco": ap(coco_idx),
            "mAP_nndet": ap(nndet_idx),
        }
        for key, subset in self.subsets.items():
            cls_idx = [int(c) - 1 for c in subset.keys()]
            out[f"mAP_coco_{key}"] = ap(coco_idx, cls_idx)
            out[f"mAP_nndet_{key}"] = ap(nndet_idx, cls_idx)
        for v, idx in zip(self._iou_list, self._iou_idx(self._iou_list)):
            out[f"AP_IoU_{v:.2f}"] = ap([idx])
        if self.per_class:
            for c, name in enumerate(self.classes):
                out[f"mAP_coco_{name}_"] = ap(coco_idx, c)
                out[f"mAP_nndet_{name}_"] = ap(nndet_idx, c)
        return out


def build_evaluator(config, per_class=False):
    """Construct from a merged experiment config (labels come from the
    dataset config / data_info.json)."""
    return DetectionEvaluator(
        classes=list(config["labels"].values()),
        classes_small=config["labels_small"],
        classes_mid=config["labels_mid"],
        classes_large=config["labels_large"],
        per_class=per_class,
    )
