"""Evaluators, the metric system (counterpart of ``paddle_tpu/evaluator.py``:
the base with its graph registry, ClassificationError, Auc,
PrecisionRecall, PnPair, Sum, ColumnSum, Chunk, CTCError, DetectionMAP,
RankAuc, SeqClassificationError, the printers and ``EvalAccumulator``).

Each evaluator is split as in the JAX package:

- ``stats(values, feed)`` reduces one batch to a few tensors of
  sufficient statistics on the device, inside the training step (and
  inside a captured chunk's graph: nothing in it reads back to the host);
- ``merge()`` / ``finish()`` fold those statistics over a pass and turn
  them into the metric, on the host, in float64.

``EvalAccumulator`` adds each batch's statistics on the device, so the
loop reads them back once, at the end of the pass; Chunk, CTCError and
DetectionMAP decode on the host (chunks, greedy CTC paths, detections),
so they are ``host_merge``: their statistics come back every batch, as
do RankAuc's lists and the printers' last batch.  GradientPrinter reads
the cotangent of its layer's output, which the trainer takes through a
zero probe added to that output (``Topology.forward(grad_probes=)``).

Usage matches v2: call a factory while building the model,
``evaluator.auc(input=prob, label=click)``, and the next ``Topology``
built over those layers takes it up; ``trainer.train`` and ``test``
report its metrics on ``EndPass`` and ``TestResult``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.ir import LayerOutput

__all__ = [
    "Evaluator", "classification_error", "auc", "precision_recall",
    "pnpair", "sum", "column_sum", "chunk", "value_printer", "ctc_error",
    "detection_map", "take_pending", "rank_auc",
    "seq_classification_error", "gradient_printer", "maxid_printer",
    "maxframe_printer", "seqtext_printer",
    "classification_error_printer", "EvalAccumulator",
    "rankauc",    # the C++ registry spelling, reachable via import *
]

_REGISTRY: List["Evaluator"] = []


def match_graph(nodes) -> List["Evaluator"]:
    """Evaluators with at least one input layer among ``nodes`` (by object
    identity).  Not consumed: every Topology built over the same layers
    takes them up."""
    node_ids = {id(n) for n in nodes}
    return [e for e in _REGISTRY
            if any(id(lo) in node_ids for lo in e.layers.values())]


def reset_registry() -> None:
    """Drop the declared evaluators (``paddle.init`` between models)."""
    _REGISTRY.clear()


def take_pending() -> List["Evaluator"]:
    """Drain the registry."""
    out = list(_REGISTRY)
    _REGISTRY.clear()
    return out


class Evaluator:
    """Base evaluator: ``layers`` maps a role to a LayerOutput; each joins
    the topology the evaluator attaches to."""

    _COUNTER = 0

    def __init__(self, name: Optional[str], layers: Dict[str, LayerOutput]):
        if name is None:
            Evaluator._COUNTER += 1
            name = f"__{type(self).__name__.lower()}_{Evaluator._COUNTER}__"
        self.name = name
        self.layers = layers
        # True: merge() folds numpy on the host at every batch; False: the
        # statistics add on the device and are read once a pass
        self.host_merge = False
        _REGISTRY.append(self)

    # -- the device part (inside the step) --------------------------------
    def stats(self, values: Dict[str, torch.Tensor], feed: dict) -> tuple:
        """One batch's statistics, a tuple of tensors."""
        raise NotImplementedError

    # -- the host part ------------------------------------------------------
    def merge(self, acc, stats):
        """Fold one batch's statistics into the accumulator (numpy)."""
        if acc is None:
            return [_f64(s) for s in stats]
        return [a + _f64(s) for a, s in zip(acc, stats)]

    def finish(self, acc) -> Dict[str, float]:
        raise NotImplementedError

    # -- helpers ------------------------------------------------------------
    def _val(self, values, role):
        return values[self.layers[role].name]

    def _mask(self, values, feed, role):
        """The validity mask of a padded sequence input, else None."""
        x = self._val(values, role)
        lens = feed.get(self.layers[role].name + "@len")
        if x.ndim >= 2 and lens is not None:
            lens = torch.as_tensor(lens, device=x.device)
            pos = torch.arange(x.shape[1], device=x.device)
            return (pos[None, :] < lens[:, None]).to(torch.float32)
        return None


def _f64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float64)


def _class_rows(ev, values, feed):
    """(scores [N, C], int labels [N], weights [N]): a sequence tagging
    input [B, T, C] flattened, its padding weighted 0."""
    pred = ev._val(values, "input")
    label = ev._val(values, "label").long()
    mask = ev._mask(values, feed, "label")
    if pred.ndim == 3:
        pred = pred.reshape(-1, pred.shape[-1])
        label = label.reshape(-1)
        w = (mask.reshape(-1) if mask is not None
             else torch.ones(label.shape, device=pred.device))
    else:
        w = torch.ones(label.shape, device=pred.device)
    return pred, label, w


class ClassificationError(Evaluator):
    """Error rate, optionally top-k (reference: ClassificationErrorEvaluator,
    gserver/evaluators/Evaluator.cpp:38)."""

    def __init__(self, input, label, name=None, top_k: int = 1):
        super().__init__(name, {"input": input, "label": label})
        self.top_k = top_k

    def stats(self, values, feed):
        pred, label, w = _class_rows(self, values, feed)
        if self.top_k == 1:
            correct = torch.argmax(pred, dim=-1) == label
        else:
            k = min(self.top_k, pred.shape[-1])
            # a stable sort, as jnp.argsort: ties keep the lower index
            topk = torch.argsort(pred, dim=-1, stable=True)[..., -k:]
            correct = torch.any(topk == label[:, None], dim=-1)
        wrong = torch.sum((1.0 - correct.to(torch.float32)) * w)
        return (wrong, torch.sum(w))

    def finish(self, acc):
        wrong, total = acc
        return {self.name: float(wrong / max(total, 1.0))}


class Auc(Evaluator):
    """ROC AUC from fixed-bin score histograms (reference: AucEvaluator,
    gserver/evaluators/Evaluator.cpp:449): a batch adds its positive and
    negative weights into BINS bins of the score; the pass's curve is
    swept from the highest bin down."""

    BINS = 4096

    def __init__(self, input, label, name=None, weight=None):
        layers = {"input": input, "label": label}
        if weight is not None:
            layers["weight"] = weight
        super().__init__(name, layers)

    def stats(self, values, feed):
        pred = self._val(values, "input")
        if pred.ndim == 2 and pred.shape[-1] == 2:
            score = pred[:, 1]                 # P(class=1)
        else:
            score = pred.reshape(-1)
        label = self._val(values, "label").to(torch.float32).reshape(-1)
        if "weight" in self.layers:
            w = self._val(values, "weight").reshape(-1)
        else:
            w = torch.ones_like(score)
        idx = torch.clamp((score * self.BINS).to(torch.int32), 0,
                          self.BINS - 1).long()
        zeros = torch.zeros(self.BINS, device=score.device)
        pos = zeros.index_add(0, idx, (label * w).to(torch.float32))
        neg = zeros.index_add(0, idx, ((1.0 - label) * w).to(torch.float32))
        return (pos, neg)

    def finish(self, acc):
        pos, neg = acc
        tp = np.cumsum(pos[::-1])
        fp = np.cumsum(neg[::-1])
        tot_pos, tot_neg = tp[-1], fp[-1]
        if tot_pos == 0 or tot_neg == 0:
            return {self.name: 0.5}
        tpr = np.concatenate([[0.0], tp / tot_pos])
        fpr = np.concatenate([[0.0], fp / tot_neg])
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return {self.name: float(trapezoid(tpr, fpr))}


class PrecisionRecall(Evaluator):
    """Per-class TP / FP / FN to macro precision, recall and F1; with
    ``positive_label`` that class only (reference:
    PrecisionRecallEvaluator, gserver/evaluators/Evaluator.cpp:576)."""

    def __init__(self, input, label, name=None, positive_label: int = -1):
        super().__init__(name, {"input": input, "label": label})
        self.positive_label = positive_label

    def stats(self, values, feed):
        pred, label, w = _class_rows(self, values, feed)
        classes = torch.arange(pred.shape[-1], device=pred.device)
        hat = torch.argmax(pred, dim=-1)
        oh_hat = (hat[:, None] == classes[None, :]) * w[:, None]
        oh_lbl = (label[:, None] == classes[None, :]) * w[:, None]
        tp = torch.sum(oh_hat * oh_lbl, dim=0)
        fp = torch.sum(oh_hat * (1 - oh_lbl), dim=0)
        fn = torch.sum((1 - oh_hat) * oh_lbl, dim=0)
        return (tp, fp, fn)

    def finish(self, acc):
        tp, fp, fn = acc
        if self.positive_label >= 0:
            tp, fp, fn = (x[self.positive_label] for x in (tp, fp, fn))
            prec = tp / max(tp + fp, 1e-12)
            rec = tp / max(tp + fn, 1e-12)
        else:
            prec = np.mean(tp / np.maximum(tp + fp, 1e-12))
            rec = np.mean(tp / np.maximum(tp + fn, 1e-12))
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        return {f"{self.name}.precision": float(prec),
                f"{self.name}.recall": float(rec),
                f"{self.name}.F1": float(f1)}


class PnPair(Evaluator):
    """Positive-negative pair ranking accuracy within query groups
    (reference: PnpairEvaluator, gserver/evaluators/Evaluator.cpp:755).
    Pairs are counted within a batch over a [B, B] query-equality mask:
    keep a query's rows in one batch (the reference assumes the same)."""

    def __init__(self, input, label, query_id, name=None, weight=None):
        layers = {"input": input, "label": label, "query": query_id}
        if weight is not None:
            layers["weight"] = weight
        super().__init__(name, layers)

    def stats(self, values, feed):
        score = self._val(values, "input").reshape(-1)
        label = self._val(values, "label").to(torch.float32).reshape(-1)
        qid = self._val(values, "query").reshape(-1)
        w = (self._val(values, "weight").reshape(-1)
             if "weight" in self.layers else torch.ones_like(score))
        same_q = qid[:, None] == qid[None, :]
        # pair (i, j): i has the higher label, so it should score higher
        pos_pair = same_q & (label[:, None] > label[None, :])
        pw = w[:, None] * w[None, :]
        ds = score[:, None] - score[None, :]
        zero = torch.zeros((), dtype=pw.dtype, device=pw.device)
        correct = torch.sum(torch.where(pos_pair, (ds > 0) * pw, zero))
        tied = torch.sum(torch.where(pos_pair, (ds == 0) * pw, zero))
        total = torch.sum(torch.where(pos_pair, pw, zero))
        return (correct, tied, total)

    def finish(self, acc):
        correct, tied, total = acc
        total = max(total, 1e-12)
        return {f"{self.name}.pos_pair_ratio":
                float((correct + 0.5 * tied) / total)}


class Sum(Evaluator):
    """The sum of a layer's output over the pass (reference: SumEvaluator,
    Evaluator.cpp:112); a padded sequence's padding is left out."""

    def __init__(self, input, name=None):
        super().__init__(name, {"input": input})

    def stats(self, values, feed):
        x = self._val(values, "input")
        mask = self._mask(values, feed, "input")
        if mask is not None and x.ndim >= 2:
            x = x * mask.reshape(tuple(mask.shape) + (1,) * (x.ndim - 2))
        # a fill, not a copy from the host: a graph can capture it
        return (torch.sum(x), x.new_full((), float(x.shape[0]),
                                         dtype=torch.float32))

    def finish(self, acc):
        s, n = acc
        return {self.name: float(s)}


class ColumnSum(Evaluator):
    """Per-column mean over the pass (reference: ColumnSumEvaluator,
    Evaluator.cpp:184)."""

    def __init__(self, input, name=None):
        super().__init__(name, {"input": input})

    def stats(self, values, feed):
        x = self._val(values, "input")
        x2 = x.reshape(-1, x.shape[-1])
        return (torch.sum(x2, dim=0), x2.new_full((), float(x2.shape[0]),
                                                  dtype=torch.float32))

    def finish(self, acc):
        s, n = acc
        return {self.name: (s / max(n, 1.0)).tolist()}


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


class Chunk(Evaluator):
    """Chunk-level precision, recall and F1 of sequence labelling
    (reference: ChunkEvaluator.cpp; IOB, IOE, IOBES and plain schemes).
    The device part gives tag ids (the argmax of scores) and the label's
    mask; the chunks are decoded on the host."""

    def __init__(self, input, label, name=None,
                 chunk_scheme: str = "IOB", num_chunk_types: int = 1):
        super().__init__(name, {"input": input, "label": label})
        self.scheme = chunk_scheme
        self.num_chunk_types = num_chunk_types
        self.host_merge = True

    def stats(self, values, feed):
        pred = self._val(values, "input")
        label = self._val(values, "label").to(torch.int32)
        if pred.ndim == label.ndim + 1:        # scores [..., C] -> tag ids
            pred = torch.argmax(pred, -1)
        mask = self._mask(values, feed, "label")
        if mask is None:
            mask = torch.ones(label.shape, dtype=torch.float32,
                              device=label.device)
        return (pred.to(torch.int32), label, mask)

    def merge(self, acc, stats):
        pred, label, mask = (_host(s) for s in stats)
        if acc is None:
            acc = np.zeros(3, np.float64)      # n_correct, n_pred, n_label
        if pred.ndim == 1:
            pred, label, mask = pred[None], label[None], mask[None]
        for b in range(pred.shape[0]):
            n = int(mask[b].sum())
            p_chunks = _extract_chunks(pred[b][:n], self.scheme,
                                       self.num_chunk_types)
            l_chunks = _extract_chunks(label[b][:n], self.scheme,
                                       self.num_chunk_types)
            acc += (len(p_chunks & l_chunks), len(p_chunks), len(l_chunks))
        return acc

    def finish(self, acc):
        correct, n_pred, n_label = acc
        prec = correct / max(n_pred, 1e-12)
        rec = correct / max(n_label, 1e-12)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        return {f"{self.name}.precision": float(prec),
                f"{self.name}.recall": float(rec),
                f"{self.name}.F1": float(f1)}


def _extract_chunks(tags, scheme: str, num_types: int) -> set:
    """The (begin, end, type) chunks of a tag sequence, the reference's
    tag layout (ChunkEvaluator.cpp getSegments): IOB tag = type * 2 +
    {0: B, 1: I}, IOE type * 2 + {0: I, 1: E}, IOBES type * 4 + {0: B,
    1: I, 2: E, 3: S}, O = num_types * (2 or 4); plain: every non-O tag
    its own chunk."""
    chunks = set()
    if scheme == "plain":
        return {(i, i, int(t)) for i, t in enumerate(tags)
                if t != num_types}
    per = {"IOB": 2, "IOE": 2, "IOBES": 4}[scheme]
    o_tag = num_types * per
    start, ctype = None, None

    def flush(end):
        if start is not None:
            chunks.add((start, end, ctype))

    for i in range(len(tags)):
        t = int(tags[i])
        if t >= o_tag or t < 0:
            flush(i - 1)
            start, ctype = None, None
            continue
        typ, pos = divmod(t, per)
        if scheme == "IOB":
            if pos == 0 or start is None or typ != ctype:
                flush(i - 1)
                start, ctype = i, typ
        elif scheme == "IOE":
            if start is None or typ != ctype:
                flush(i - 1)
                start, ctype = i, typ
            if pos == 1:                        # E closes the chunk
                flush(i)
                start, ctype = None, None
        else:                                   # IOBES
            if pos == 3:                        # S
                flush(i - 1)
                chunks.add((i, i, typ))
                start, ctype = None, None
            elif pos == 0 or start is None or typ != ctype:   # B
                flush(i - 1)
                start, ctype = i, typ
            if pos == 2 and start is not None:  # E
                flush(i)
                start, ctype = None, None
    flush(len(tags) - 1)
    return chunks


class CTCError(Evaluator):
    """Edit distance after greedy CTC decoding over the total label length
    (reference: CTCErrorEvaluator.cpp).  The device part gives the frames'
    argmax ids and both masks; decoding and the distance run on the
    host."""

    def __init__(self, input, label, name=None, blank: int = 0):
        super().__init__(name, {"input": input, "label": label})
        self.blank = blank
        self.host_merge = True

    def stats(self, values, feed):
        logits = self._val(values, "input")
        ids = (torch.argmax(logits, -1) if logits.ndim == 3
               else logits).to(torch.int32)
        tmask = self._mask(values, feed, "input")
        if tmask is None:
            tmask = torch.ones(ids.shape, dtype=torch.float32,
                               device=ids.device)
        label = self._val(values, "label").to(torch.int32)
        lmask = self._mask(values, feed, "label")
        if lmask is None:
            lmask = torch.ones(label.shape, dtype=torch.float32,
                               device=label.device)
        return (ids, tmask, label, lmask)

    def merge(self, acc, stats):
        from paddle_tpu_torch.layers.crf_ctc import (ctc_greedy_decode,
                                                     edit_distance)
        ids, tmask, label, lmask = (_host(s) for s in stats)
        if acc is None:
            acc = np.zeros(2, np.float64)      # distance, label length
        for b in range(ids.shape[0]):
            t = int(tmask[b].sum())
            n = int(lmask[b].sum())
            hyp = ctc_greedy_decode(ids[b][:t], blank=self.blank)
            acc += (edit_distance(hyp, list(label[b][:n])), max(n, 1))
        return acc

    def finish(self, acc):
        dist, total = acc
        return {self.name: float(dist / max(total, 1e-12))}


def _np_iou(row, boxes):
    """The IoU of one box with boxes [G, 4], on the host."""
    lt = np.maximum(row[:2], boxes[:, :2])
    rb = np.minimum(row[2:], boxes[:, 2:])
    wh = np.maximum(rb - lt, 0.0)
    inter = wh[:, 0] * wh[:, 1]

    def area(b):
        return (np.maximum(b[..., 2] - b[..., 0], 0)
                * np.maximum(b[..., 3] - b[..., 1], 0))

    union = area(row) + area(boxes) - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-10), 0.0)


class DetectionMAP(Evaluator):
    """Mean average precision of ``detection_output`` rows (reference:
    DetectionMAPEvaluator.cpp, 11-point or integral AP).  input: [B, K, 6]
    (label, score, box; label -1 pads); label [B, G] (-1 pads) and gt_box
    [B, G, 4].  The detections and ground truths gather on the host, and
    each class's AP is computed at the pass's end."""

    def __init__(self, input, label, gt_box, name=None,
                 overlap_threshold: float = 0.5, ap_type: str = "11point"):
        super().__init__(name, {"input": input, "label": label,
                                "gt_box": gt_box})
        self.overlap_threshold = overlap_threshold
        self.ap_type = ap_type
        self.host_merge = True

    def stats(self, values, feed):
        return (self._val(values, "input"),
                self._val(values, "label").to(torch.int32),
                self._val(values, "gt_box"))

    def merge(self, acc, stats):
        dets, labels, gtb = (_host(s) for s in stats)
        if acc is None:
            acc = {"dets": [], "gts": []}
        base = len(acc["gts"])
        for b in range(dets.shape[0]):
            rows = dets[b]
            keep = rows[:, 0] >= 0
            acc["dets"].append(np.concatenate(
                [np.full((int(keep.sum()), 1), base + b), rows[keep]], 1))
            g = labels[b] >= 0
            acc["gts"].append((labels[b][g], gtb[b][g]))
        return acc

    def finish(self, acc):
        if acc is None or not acc["gts"]:
            return {self.name: 0.0}
        dets = (np.concatenate(acc["dets"], 0) if acc["dets"]
                else np.zeros((0, 7)))
        classes = sorted({int(c) for lab, _ in acc["gts"] for c in lab})
        aps = []
        for c in classes:
            n_gt = int(np.sum([(lab == c).sum() for lab, _ in acc["gts"]]))
            rows = dets[dets[:, 1] == c]
            rows = rows[np.argsort(-rows[:, 2])]
            matched = [set() for _ in acc["gts"]]
            tp = np.zeros(len(rows))
            fp = np.zeros(len(rows))
            for i, row in enumerate(rows):
                img = int(row[0])
                lab, gb = acc["gts"][img]
                cand = np.where(lab == c)[0]
                if len(cand) == 0:
                    fp[i] = 1
                    continue
                ious = _np_iou(row[3:7].astype(np.float64),
                               gb[cand].astype(np.float64))
                j = int(ious.argmax())
                if (ious[j] >= self.overlap_threshold
                        and int(cand[j]) not in matched[img]):
                    tp[i] = 1
                    matched[img].add(int(cand[j]))
                else:
                    fp[i] = 1
            if n_gt == 0:
                continue
            rec = np.cumsum(tp) / n_gt
            prec = np.cumsum(tp) / np.maximum(
                np.cumsum(tp) + np.cumsum(fp), 1e-12)
            if self.ap_type == "11point":
                ap = np.mean([prec[rec >= t].max() if (rec >= t).any()
                              else 0.0 for t in np.linspace(0, 1, 11)])
            else:                                   # integral
                ap = 0.0
                for i in range(len(rec)):
                    ap += (rec[i] - (rec[i - 1] if i else 0.0)) * prec[i]
            aps.append(ap)
        return {self.name: float(np.mean(aps)) if aps else 0.0}


def _top_k(x, k):
    """(ids, values) of the k largest per row, largest first, ties in the
    order of ``jnp.argsort`` (stable, ascending) read backwards."""
    idx = torch.argsort(x, dim=-1, stable=True)[:, -k:].flip(-1)
    return idx, torch.gather(x, -1, idx)


def _lens(ev, values, feed, x):
    """Each row's length: the mask's sum of a padded sequence, else T."""
    mask = ev._mask(values, feed, "input")
    if mask is not None:
        return mask.sum(dim=1).to(torch.int32), mask
    t = x.shape[1] if x.ndim > 1 else 1
    return torch.full((x.shape[0],), t, dtype=torch.int32,
                      device=x.device), None


class RankAuc(Evaluator):
    """Per-list ranking AUC, averaged over lists (reference:
    RankAucEvaluator, Evaluator.cpp:514-592: each sequence is one list;
    click / pv columns weight the positives / negatives; ties credit by
    trapezoid).  Inputs are padded sequences [B, T(, 1)] with @len; pv
    omitted means one view per item."""

    def __init__(self, input, click, pv=None, name=None):
        layers = {"input": input, "click": click}
        if pv is not None:
            layers["pv"] = pv
        super().__init__(name, layers)
        self.has_pv = pv is not None
        self.host_merge = True

    def stats(self, values, feed):
        score = self._val(values, "input")
        click = self._val(values, "click")
        if score.ndim == 3:
            score = score[..., 0]
        if click.ndim == 3:
            click = click[..., 0]
        pv = (self._val(values, "pv") if self.has_pv
              else torch.ones_like(click))
        if pv.ndim == 3:
            pv = pv[..., 0]
        mask = self._mask(values, feed, "input")
        if mask is None:
            mask = torch.ones(score.shape[:2], device=score.device)
        return (score, click.to(torch.float32), pv.to(torch.float32), mask)

    def merge(self, acc, stats):
        acc = acc or [0.0, 0]
        score, click, pv, mask = (_host(s) for s in stats)
        for b in range(score.shape[0]):
            n = int(mask[b].sum())
            if n == 0:
                continue
            acc[0] += self._list_auc(score[b, :n], click[b, :n], pv[b, :n])
            acc[1] += 1
        return acc

    @staticmethod
    def _list_auc(score, click, pv):
        """The reference's calcRankAuc (Evaluator.cpp:555): a sweep down
        the scores adding click / no-click trapezoids."""
        order = np.argsort(-score, kind="stable")
        auc = click_sum = old_click_sum = 0.0
        no_click = no_click_sum = 0.0
        last = float(score[order[0]]) + 1.0
        for idx in order:
            if last != float(score[idx]):
                auc += (click_sum + old_click_sum) * no_click / 2.0
                old_click_sum = click_sum
                no_click = 0.0
                last = float(score[idx])
            no_click += float(pv[idx]) - float(click[idx])
            no_click_sum += no_click
            click_sum += float(click[idx])
        auc += (click_sum + old_click_sum) * no_click / 2.0
        denom = click_sum * no_click_sum
        return 0.0 if denom == 0.0 else auc / denom

    def finish(self, acc):
        if not acc or acc[1] == 0:
            return {self.name: 0.0}
        return {self.name: float(acc[0] / acc[1])}


class SeqClassificationError(Evaluator):
    """Sequence-level error: a sequence errs if ANY frame errs
    (reference: SequenceClassificationErrorEvaluator,
    Evaluator.cpp:136-173)."""

    def __init__(self, input, label, name=None):
        super().__init__(name, {"input": input, "label": label})

    def stats(self, values, feed):
        pred = self._val(values, "input")       # [B, T, C]
        label = self._val(values, "label").long()
        mask = self._mask(values, feed, "label")
        if mask is None:
            mask = torch.ones(label.shape, device=pred.device)
        frame_err = torch.argmax(pred, dim=-1) != label
        seq_err = torch.any(frame_err & (mask > 0), dim=1)
        return (torch.sum(seq_err.to(torch.float32)),
                pred.new_full((), float(label.shape[0]),
                              dtype=torch.float32))

    def finish(self, acc):
        wrong, total = acc
        return {self.name: float(wrong / max(total, 1.0))}


class ValuePrinter(Evaluator):
    """Print the last batch's layer values at the pass end (reference:
    ValuePrinter, Evaluator.cpp:1020)."""

    def __init__(self, input, name=None):
        super().__init__(name, {"input": input})
        self.host_merge = True

    def stats(self, values, feed):
        return (self._val(values, "input"),)

    def merge(self, acc, stats):
        return [_host(stats[0])]               # keep the last batch only

    def finish(self, acc):
        print(f"[{self.name}] value:\n{acc[0]}")
        return {}


class GradientPrinter(Evaluator):
    """Print d(cost)/d(layer output) for the last batch (reference:
    GradientPrinter, Evaluator.cpp:1058).  The trainer takes the
    cotangent through a zero probe added to the layer's output
    (``grad_layers`` -> ``Topology.forward(grad_probes=)``); a test pass
    runs no backward, as the reference's ``if (argu.grad)`` guard."""

    def __init__(self, input, name=None):
        super().__init__(name, {"input": input})
        self.host_merge = True
        self.grad_layers = [input.name]

    def stats(self, values, feed):
        g = values.get(self.layers["input"].name + "@grad")
        return (g,) if g is not None else ()

    def merge(self, acc, stats):
        return [_host(stats[0])] if stats else []

    def finish(self, acc):
        if acc:
            print(f"[{self.name}] grad:\n{acc[0]}")
        else:
            print(f"[{self.name}] grad: (no backward ran)")
        return {}


class MaxIdPrinter(Evaluator):
    """Print the top-k (id: value) of each row of the last batch
    (reference: MaxIdPrinter, Evaluator.cpp:1080)."""

    def __init__(self, input, name=None, num_results: int = 1):
        super().__init__(name, {"input": input})
        self.k = num_results
        self.host_merge = True

    def stats(self, values, feed):
        x = self._val(values, "input")
        if x.ndim == 3:
            x = x.reshape(-1, x.shape[-1])
        return _top_k(x, min(self.k, x.shape[-1]))

    def merge(self, acc, stats):
        return [_host(s) for s in stats]

    def finish(self, acc):
        if acc:
            ids, vals = acc
            lines = [", ".join(f"{int(i)} : {float(v):.6g}"
                               for i, v in zip(ri, rv))
                     for ri, rv in zip(ids, vals)]
            print(f"[{self.name}] row max ids:\n" + "\n".join(lines))
        return {}


class MaxFramePrinter(Evaluator):
    """Per sequence, print the top-k frame positions of a width-1 output
    (reference: MaxFramePrinter, Evaluator.cpp:1105)."""

    def __init__(self, input, name=None, num_results: int = 1):
        super().__init__(name, {"input": input})
        self.k = num_results
        self.host_merge = True

    def stats(self, values, feed):
        x = self._val(values, "input")          # [B, T] or [B, T, 1]
        if x.ndim == 3:
            x = x[..., 0]
        lens, mask = _lens(self, values, feed, x)
        if mask is not None:
            x = torch.where(mask > 0, x, torch.full_like(x, -float("inf")))
        idx, vals = _top_k(x, min(self.k, x.shape[1]))
        return (idx, vals, lens)

    def merge(self, acc, stats):
        return [_host(s) for s in stats]

    def finish(self, acc):
        if acc:
            ids, vals, lens = acc
            lines = []
            for ri, rv, n in zip(ids, vals, lens):
                k = min(self.k, int(n))
                lines.append(", ".join(
                    f"{int(i)} : {float(v):.6g}"
                    for i, v in zip(ri[:k], rv[:k]))
                    + f", total {int(n)} frames")
            print(f"[{self.name}] sequence max frames:\n"
                  + "\n".join(lines))
        return {}


class SeqTextPrinter(Evaluator):
    """Decode id sequences through a dictionary and write one line a
    sample to ``result_file`` (reference: SequenceTextPrinter,
    Evaluator.cpp:1155, the generation-output printer)."""

    def __init__(self, input, dict_file=None, result_file=None, name=None,
                 delimited: bool = True):
        super().__init__(name, {"input": input})
        self.dict_file = dict_file
        self.result_file = result_file
        self.delimited = delimited
        self.host_merge = True

    def stats(self, values, feed):
        x = self._val(values, "input")
        lens, _ = _lens(self, values, feed, x)
        return (x.to(torch.int32), lens)

    def merge(self, acc, stats):
        acc = acc or []
        acc.append((_host(stats[0]), _host(stats[1])))
        return acc

    def finish(self, acc):
        words = None
        if self.dict_file:
            with open(self.dict_file) as f:
                words = [ln.rstrip("\n") for ln in f]
        sep = " " if self.delimited else ""
        lines = []
        sample = 0
        for ids, lens in (acc or []):
            ids = ids.reshape(ids.shape[0], -1)
            for row, n in zip(ids, lens):
                toks = [words[t] if words and 0 <= t < len(words)
                        else str(int(t)) for t in row[:int(n)]]
                lines.append(f"{sample}\t{sep.join(toks)}")
                sample += 1
        text = "\n".join(lines)
        if self.result_file:
            with open(self.result_file, "w") as f:
                f.write(text + "\n")
        else:
            print(f"[{self.name}] sequences:\n{text}")
        return {}


class ClassificationErrorPrinter(Evaluator):
    """Print the last batch's per-sample 0/1 error vector (reference:
    ClassificationErrorPrinter, Evaluator.cpp:1340)."""

    def __init__(self, input, label, name=None):
        super().__init__(name, {"input": input, "label": label})
        self.host_merge = True

    def stats(self, values, feed):
        pred = self._val(values, "input")
        label = self._val(values, "label").long()
        if pred.ndim == 3:
            pred = pred.reshape(-1, pred.shape[-1])
            label = label.reshape(-1)
        return ((torch.argmax(pred, dim=-1) != label).to(torch.float32),)

    def merge(self, acc, stats):
        return [_host(stats[0])]

    def finish(self, acc):
        if acc:
            print(f"[{self.name}] classification error:\n{acc[0]}")
        return {}


# ------------------------------------------------------------- factories
def classification_error(input, label, name=None, top_k=1, **kw):
    return ClassificationError(input, label, name=name, top_k=top_k)


def auc(input, label, name=None, weight=None, **kw):
    return Auc(input, label, name=name, weight=weight)


def precision_recall(input, label, name=None, positive_label=-1, **kw):
    return PrecisionRecall(input, label, name=name,
                           positive_label=positive_label)


def sum(input, name=None, **kw):                # noqa: A001 (v2 API name)
    return Sum(input, name=name)


def column_sum(input, name=None, **kw):
    return ColumnSum(input, name=name)


def chunk(input, label, name=None, chunk_scheme="IOB",
          num_chunk_types=1, **kw):
    return Chunk(input, label, name=name, chunk_scheme=chunk_scheme,
                 num_chunk_types=num_chunk_types)


def ctc_error(input, label, name=None, blank=0, **kw):
    return CTCError(input, label, name=name, blank=blank)


def detection_map(input, label, gt_box, name=None, overlap_threshold=0.5,
                  ap_type="11point", **kw):
    return DetectionMAP(input, label, gt_box, name=name,
                        overlap_threshold=overlap_threshold,
                        ap_type=ap_type)


def pnpair(input, label, query_id, name=None, weight=None, **kw):
    return PnPair(input, label, query_id, name=name, weight=weight)


def rank_auc(input, click, pv=None, name=None, **kw):
    return RankAuc(input, click, pv=pv, name=name)


# the C++ registry spelling (REGISTER_EVALUATOR(rankauc, ...))
rankauc = rank_auc


def seq_classification_error(input, label, name=None, **kw):
    return SeqClassificationError(input, label, name=name)


def value_printer(input, name=None, **kw):
    return ValuePrinter(input, name=name)


def gradient_printer(input, name=None, **kw):
    return GradientPrinter(input, name=name)


def maxid_printer(input, name=None, num_results=1, **kw):
    return MaxIdPrinter(input, name=name, num_results=num_results)


def maxframe_printer(input, name=None, num_results=1, **kw):
    return MaxFramePrinter(input, name=name, num_results=num_results)


def seqtext_printer(input, dict_file=None, result_file=None, name=None,
                    delimited=True, **kw):
    return SeqTextPrinter(input, dict_file=dict_file,
                          result_file=result_file, name=name,
                          delimited=delimited)


def classification_error_printer(input, label, name=None, **kw):
    return ClassificationErrorPrinter(input, label, name=name)


# ----------------------------------------------------- the trainer's side
class EvalAccumulator:
    """Accumulates evaluator statistics over a pass.  Device-mergeable
    evaluators add their tensors on the device, so the
    loop never waits on the card for them; ``results()`` reads them back
    once and finishes in float64."""

    def __init__(self, evaluators: Sequence[Evaluator]):
        self.evaluators = list(evaluators)
        self.accs = {e.name: None for e in self.evaluators}

    def update(self, all_stats: Dict[str, tuple]) -> None:
        for e in self.evaluators:
            stats = all_stats[e.name]
            if e.host_merge:
                self.accs[e.name] = e.merge(self.accs[e.name], stats)
            elif self.accs[e.name] is None:
                self.accs[e.name] = list(stats)
            else:
                self.accs[e.name] = [a + s for a, s in
                                     zip(self.accs[e.name], stats)]

    def results(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for e in self.evaluators:
            acc = self.accs[e.name]
            if acc is None:
                continue
            if not e.host_merge:
                acc = [_f64(a) for a in acc]
            out.update(e.finish(acc))
        return out

    def reset(self) -> None:
        self.accs = {e.name: None for e in self.evaluators}
