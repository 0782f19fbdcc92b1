"""Evaluators, the metric system (counterpart of ``paddle_tpu/evaluator.py``:
the base with its graph registry, ClassificationError, Auc,
PrecisionRecall, Sum, ColumnSum and ``EvalAccumulator``).

Each evaluator is split as in the JAX package:

- ``stats(values, feed)`` reduces one batch to a few tensors of
  sufficient statistics on the device, inside the training step (and
  inside a captured chunk's graph: nothing in it reads back to the host);
- ``merge()`` / ``finish()`` fold those statistics over a pass and turn
  them into the metric, on the host, in float64.

``EvalAccumulator`` adds each batch's statistics on the device, so the
loop reads them back once, at the end of the pass.

Usage matches v2: call a factory while building the model,
``evaluator.auc(input=prob, label=click)``, and the next ``Topology``
built over those layers takes it up; ``trainer.train`` and ``test``
report its metrics on ``EndPass`` and ``TestResult``.

Not ported yet, and refused: Chunk, PnPair, CTCError, DetectionMAP,
RankAuc, SeqClassificationError and the printers (``ROADMAP.md`` section
1, item 11).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.ir import LayerOutput

__all__ = [
    "Evaluator", "classification_error", "auc", "precision_recall", "sum",
    "column_sum", "take_pending", "EvalAccumulator",
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


def _not_ported(name):
    def factory(*args, **kwargs):
        raise NotImplementedError(
            f"the {name} evaluator is not ported to paddle_tpu_torch yet "
            f"(ROADMAP.md section 1, item 11)")
    factory.__name__ = name
    return factory


pnpair = _not_ported("pnpair")
chunk = _not_ported("chunk")
ctc_error = _not_ported("ctc_error")
detection_map = _not_ported("detection_map")
rank_auc = rankauc = _not_ported("rank_auc")
seq_classification_error = _not_ported("seq_classification_error")
value_printer = _not_ported("value_printer")
gradient_printer = _not_ported("gradient_printer")
maxid_printer = _not_ported("maxid_printer")
maxframe_printer = _not_ported("maxframe_printer")
seqtext_printer = _not_ported("seqtext_printer")
classification_error_printer = _not_ported("classification_error_printer")


# ----------------------------------------------------- the trainer's side
class EvalAccumulator:
    """Accumulates evaluator statistics over a pass.  Device-mergeable
    evaluators (every ported one) add their tensors on the device, so the
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
