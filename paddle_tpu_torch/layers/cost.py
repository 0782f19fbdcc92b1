"""Cost (loss) layers (counterpart of ``paddle_tpu/layers/cost.py``):
``classification_cost``, the fused LM head ``lm_head_cost``, the
prob-space, regression, ranking and margin costs, NCE, hierarchical
sigmoid, ``lambda_cost`` and ``cross_entropy_over_beam``.

All costs reduce to per-sample losses, then a (weighted) mean over the
batch.  ``classification_cost`` takes logits and fuses log-softmax and NLL
in ``_SoftmaxNLL``, which saves the logits and the [N] logsumexp, never a
log-prob matrix: at the LM's full width (32768 tokens x 32000 classes)
``F.cross_entropy`` would keep another 4.2 GB float32 log-softmax for the
backward.  ``lm_head_cost`` owns the head's weights and saves not even
the logits (``ops/chunked_ce.py``).

Under every precision policy the costs compute in float32 and return a
float32 scalar (the policy's ``output_dtype``), as the JAX cost layers
do: ``_SoftmaxNLL`` upcasts bf16 logits in its forward and returns their
gradient in their own dtype.  NCE draws its shared negatives from the
forward's generator (``ApplyContext.rng``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.ir import ParamSpec
from paddle_tpu_torch.core.registry import LayerDef, register_layer
from paddle_tpu_torch.layers.sequence import SeqLayerDef
from paddle_tpu_torch.ops.chunked_ce import lm_head_nll


def _f32(x):
    """loss math runs in float32 whatever the activations' dtype."""
    return x.float()


def _weighted_mean(per_sample, weight=None):
    if weight is not None:
        w = weight.reshape(per_sample.shape)
        return (per_sample * w).sum() / torch.clamp(w.sum(), min=1e-12)
    return per_sample.mean()


class _CostBase(LayerDef):
    def infer_shape(self, attrs, in_shapes):
        return ()          # scalar


class _SoftmaxNLL(torch.autograd.Function):
    """Per-sample softmax cross-entropy (counterpart of the custom-vjp
    ``_softmax_nll``): forward = two reductions over the logits; backward =
    one elementwise pass, dlogits = (softmax - onehot) * g, built in place
    in one [N, V] buffer."""

    @staticmethod
    def forward(ctx, logits, labels):
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        ll = lf.gather(-1, labels[:, None])[:, 0]
        ctx.save_for_backward(logits, labels, lse)
        return lse - ll

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        d = torch.sub(logits.float(), lse[:, None]).exp_()
        rows = torch.arange(d.shape[0], device=d.device)
        d[rows, labels] -= 1.0
        d.mul_(g[:, None].to(d.dtype))
        return d.to(logits.dtype), None


@register_layer
class ClassificationCost(_CostBase):
    """softmax cross-entropy on logits (+ optional per-sample weight)."""

    kind = "classification_cost"

    def apply(self, attrs, params, inputs, ctx):
        logits, label = inputs[0], inputs[1]
        weight = inputs[2] if len(inputs) > 2 else None
        label = label.reshape(-1).long()
        if attrs.get("input_is_prob"):
            # input already softmax-ed (the reference's prob-space idiom)
            logp = torch.log(torch.clamp(logits.float(), min=1e-10))
            nll = -logp.gather(-1, label[:, None])[:, 0]
        else:
            nll = _SoftmaxNLL.apply(logits, label)
        return _weighted_mean(nll, weight)


@register_layer
class SumCost(_CostBase):
    """sum of the input over the batch's rows, divided by their count
    (reference: SumCostLayer)."""

    kind = "sum_cost"

    def apply(self, attrs, params, inputs, ctx):
        return torch.sum(inputs[0].float()) / inputs[0].shape[0]


@register_layer
class LmHeadCost(_CostBase):
    """Fused vocabulary projection + softmax cross-entropy, chunked
    (``ops/chunked_ce.py``): the [N, vocab] logits are never kept.  Owns
    the head parameters (``w0``/``b``, fc naming) so a ``share_from`` fc
    can expose the logits themselves for generation.  attrs: vocab_size,
    chunk (rows per step of the loop).  x and w take the policy's compute
    dtype, b does not."""

    kind = "lm_head_cost"

    def param_specs(self, attrs, in_shapes):
        d = in_shapes[0][-1]
        return [ParamSpec("w0", (d, attrs["vocab_size"]), "xavier"),
                ParamSpec("b", (attrs["vocab_size"],), "zeros")]

    def apply(self, attrs, params, inputs, ctx):
        x, label = inputs[0], inputs[1]
        weight = inputs[2] if len(inputs) > 2 else None
        w, b = params["w0"], params["b"]
        if ctx.compute_dtype is not None:
            x = x.to(ctx.compute_dtype)
            w = w.to(ctx.compute_dtype)
        nll = lm_head_nll(x, w, b, label.reshape(-1),
                          attrs.get("chunk", 8192))
        return _weighted_mean(nll, weight)


@register_layer
class CrossEntropyCost(_CostBase):
    """cross-entropy on probabilities (input already softmax-ed) or, with
    attrs["soft_label"], on a label distribution (reference:
    MultiClassCrossEntropy, prob-space)."""

    kind = "cross_entropy"

    def apply(self, attrs, params, inputs, ctx):
        probs, label = _f32(inputs[0]), inputs[1]
        weight = inputs[2] if len(inputs) > 2 else None
        logp = torch.log(torch.clamp(probs, 1e-10, 1.0))
        if attrs.get("soft_label", False):
            nll = -torch.sum(label * logp, dim=-1)
        else:
            nll = -logp.gather(-1, label.long().reshape(-1, 1))[:, 0]
        return _weighted_mean(nll, weight)


@register_layer
class MSECost(_CostBase):
    """sum-of-squares / 2 (reference: SumOfSquaresCostLayer)."""

    kind = "mse_cost"

    def apply(self, attrs, params, inputs, ctx):
        pred, target = _f32(inputs[0]), _f32(inputs[1])
        target = target.reshape(pred.shape)
        per = 0.5 * torch.sum(
            torch.square(pred - target).reshape(pred.shape[0], -1), dim=-1)
        return _weighted_mean(per, inputs[2] if len(inputs) > 2 else None)


@register_layer
class SigmoidCrossEntropyCost(_CostBase):
    """multi-label binary cross-entropy on logits, the stable form
    (reference: sigmoid_cross_entropy_with_logits)."""

    kind = "multi_binary_label_cross_entropy"

    def apply(self, attrs, params, inputs, ctx):
        x, z = _f32(inputs[0]), inputs[1].float()
        z = z.reshape(x.shape)
        per = (torch.clamp(x, min=0.0) - x * z
               + torch.log1p(torch.exp(-torch.abs(x))))
        return _weighted_mean(torch.sum(per.reshape(x.shape[0], -1), dim=-1))


@register_layer
class SmoothL1Cost(_CostBase):
    """smooth-l1 / huber with delta 1 (reference: SmoothL1CostLayer)."""

    kind = "smooth_l1_cost"

    def apply(self, attrs, params, inputs, ctx):
        pred = _f32(inputs[0])
        target = _f32(inputs[1]).reshape(inputs[0].shape)
        d = pred - target
        ad = torch.abs(d)
        per = torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)
        return _weighted_mean(torch.sum(per.reshape(pred.shape[0], -1),
                                        dim=-1))


@register_layer
class HuberClassificationCost(_CostBase):
    """two-class huber on {0,1} labels (reference:
    HuberTwoClassification)."""

    kind = "huber_classification_cost"

    def apply(self, attrs, params, inputs, ctx):
        pred = _f32(inputs[0]).reshape(-1)
        y = inputs[1].float().reshape(-1) * 2.0 - 1.0    # {0,1} -> {-1,1}
        m = y * pred
        per = torch.where(m < -1.0, -4.0 * m,
                          torch.where(m < 1.0, torch.square(1.0 - m),
                                      torch.zeros_like(m)))
        return _weighted_mean(per)


@register_layer
class RankCost(_CostBase):
    """pairwise rank loss (reference: RankingCost):
    C = log(1 + exp(o_left - o_right)) - label * (o_left - o_right)."""

    kind = "rank_cost"

    def apply(self, attrs, params, inputs, ctx):
        left, right, label = _f32(inputs[0]), _f32(inputs[1]), inputs[2]
        o = (left - right).reshape(-1)
        lab = label.float().reshape(-1)
        per = (torch.log1p(torch.exp(-torch.abs(o)))
               + torch.clamp(o, min=0.0) - lab * o)
        return _weighted_mean(per, inputs[3] if len(inputs) > 3 else None)


@register_layer
class HingeCost(_CostBase):
    """binary hinge on {0,1} labels (reference: hinge_loss)."""

    kind = "hinge_cost"

    def apply(self, attrs, params, inputs, ctx):
        pred = _f32(inputs[0]).reshape(-1)
        y = inputs[1].float().reshape(-1) * 2.0 - 1.0
        return _weighted_mean(torch.clamp(1.0 - y * pred, min=0.0))


@register_layer
class LogLossCost(_CostBase):
    """log loss on a probability input (reference: log_loss)."""

    kind = "log_loss"

    def apply(self, attrs, params, inputs, ctx):
        p = torch.clamp(_f32(inputs[0]).reshape(-1), 1e-7, 1.0 - 1e-7)
        y = inputs[1].float().reshape(-1)
        return _weighted_mean(-(y * torch.log(p)
                                + (1.0 - y) * torch.log(1.0 - p)))


@register_layer
class NCECost(_CostBase):
    """noise-contrastive estimation (reference: NCELayer.cpp), the JAX
    package's design: one shared set of negatives per batch, drawn from
    the forward's generator, and the logistic loss over [target + shared
    negatives] with one dense product."""

    kind = "nce_cost"

    def param_specs(self, attrs, in_shapes):
        d = int(math.prod(in_shapes[0]))
        return [ParamSpec("w", (attrs["num_classes"], d), "xavier"),
                ParamSpec("b", (attrs["num_classes"],), "zeros")]

    def apply(self, attrs, params, inputs, ctx):
        x, label = _f32(inputs[0]), inputs[1].long().reshape(-1)
        num_neg = attrs.get("num_neg_samples", 10)
        num_classes = attrs["num_classes"]
        neg = torch.randint(0, num_classes, (num_neg,), generator=ctx.rng(),
                            device=x.device)
        w, b = params["w"], params["b"]
        logit_true = torch.sum(x * w[label], dim=-1) + b[label]
        logit_neg = x @ w[neg].t() + b[neg]                  # (B, K)
        ln_k = math.log(float(num_neg) / num_classes)
        pos = -F.logsigmoid(logit_true - ln_k)
        negl = -torch.sum(F.logsigmoid(-(logit_neg - ln_k)), dim=-1)
        return torch.mean(pos + negl)


@register_layer
class HSigmoidCost(_CostBase):
    """hierarchical sigmoid (reference: HierarchicalSigmoidLayer.cpp) on
    the reference's implicit complete binary tree: class c's code is
    c + num_classes, the internal nodes rows of one (num_classes - 1, D)
    matrix, a static path of ceil(log2 C) steps."""

    kind = "hsigmoid_cost"

    def param_specs(self, attrs, in_shapes):
        d = int(math.prod(in_shapes[0]))
        c = attrs["num_classes"]
        return [ParamSpec("w", (c - 1, d), "xavier"),
                ParamSpec("b", (c - 1,), "zeros")]

    def apply(self, attrs, params, inputs, ctx):
        x, label = _f32(inputs[0]), inputs[1].long().reshape(-1)
        c = attrs["num_classes"]
        code = label + c
        depth = int(math.floor(math.log2(2 * c - 1))) + 1
        loss = torch.zeros(x.shape[0], device=x.device)
        for shift in range(depth - 1):
            node = code >> (shift + 1)            # ancestor internal node
            bit = (code >> shift) & 1             # branch taken below it
            valid = (node >= 1) & (node <= c - 1)
            idx = torch.clamp(node - 1, 0, c - 2)
            logit = (torch.sum(x * params["w"][idx], dim=-1)
                     + params["b"][idx])
            # bit 1 -> right branch: P = sigmoid(-logit)
            sgn = 1.0 - 2.0 * bit.float()
            step = -F.logsigmoid(sgn * logit)
            loss = loss + torch.where(valid, step, torch.zeros_like(step))
        return torch.mean(loss)


@register_layer
class HuberRegressionCost(_CostBase):
    """huber regression with threshold delta (reference:
    HuberRegressionLoss)."""

    kind = "huber_regression_cost"

    def apply(self, attrs, params, inputs, ctx):
        delta = float(attrs.get("delta", 1.0))
        pred = _f32(inputs[0])
        target = _f32(inputs[1]).reshape(inputs[0].shape)
        ad = torch.abs(pred - target)
        per = torch.where(ad <= delta, 0.5 * ad * ad,
                          delta * (ad - 0.5 * delta))
        return _weighted_mean(
            torch.sum(per.reshape(pred.shape[0], -1), dim=-1),
            inputs[2] if len(inputs) > 2 else None)


@register_layer
class CrossEntropyWithSelfNorm(_CostBase):
    """CE + alpha * log(Z)^2, the softmax self-normalisation penalty
    (reference: MultiClassCrossEntropyWithSelfNorm).  On logits (the
    default) Z = sum(exp(x)) by one logsumexp; ``input_is_prob`` takes
    the reference's prob-space input."""

    kind = "cross_entropy_with_selfnorm"

    def apply(self, attrs, params, inputs, ctx):
        alpha = float(attrs.get("softmax_selfnorm_alpha", 0.1))
        x, label = inputs[0], inputs[1].long().reshape(-1, 1)
        if attrs.get("input_is_prob", False):
            logz = torch.log(torch.clamp(torch.sum(x, dim=-1), min=1e-10))
            logp = torch.log(torch.clamp(x, min=1e-10))
        else:
            logz = torch.logsumexp(x, dim=-1)
            logp = x
        nll = -(logp.gather(-1, label)[:, 0] - logz)
        return _weighted_mean(nll + alpha * torch.square(logz))


# ------------------------------------------------------------- lambda_cost
class _SeqCostBase(SeqLayerDef):
    out_is_seq = False

    def infer_shape(self, attrs, in_shapes):
        return ()


def _argsort_desc(x):
    """jnp.argsort(-x): stable, so ties keep their order."""
    return torch.argsort(-x, dim=1, stable=True)


def _ndcg_value(o, s, mask, trunc):
    """mean NDCG@trunc over the batch; o, s, mask: [B, L]."""
    big = 1e30
    neg = torch.full_like(o, -big)
    order = _argsort_desc(torch.where(mask > 0, o, neg))
    s_by_o = s.gather(1, order)
    m_by_o = mask.gather(1, order)
    pos = torch.arange(o.shape[1], dtype=o.dtype, device=o.device)
    disc = 1.0 / torch.log(pos + 2.0)
    k = (pos < trunc).to(o.dtype)
    dcg = torch.sum((2.0 ** s_by_o - 1.0) * disc * k * m_by_o, dim=1)
    ideal = _argsort_desc(torch.where(mask > 0, s, neg))
    s_i = s.gather(1, ideal)
    m_i = mask.gather(1, ideal)
    maxdcg = torch.sum((2.0 ** s_i - 1.0) * disc * k * m_i, dim=1)
    return torch.mean(dcg / torch.clamp(maxdcg, min=1e-12))


class _LambdaCost(torch.autograd.Function):
    """Forward: mean NDCG@trunc; backward: the LambdaRank pair gradients
    (the JAX package's custom vjp, one [L, L] block per query)."""

    @staticmethod
    def forward(ctx, o, s, mask, trunc, max_sort):
        ctx.save_for_backward(o, s, mask)
        ctx.trunc, ctx.max_sort = trunc, max_sort
        return _ndcg_value(o, s, mask, trunc)

    @staticmethod
    def backward(ctx, g):
        o, s, mask = ctx.saved_tensors
        trunc, max_sort = ctx.trunc, ctx.max_sort
        b, length = o.shape
        perm = _argsort_desc(torch.where(mask > 0, s,
                                         torch.full_like(s, -1e30)))
        s_p = s.gather(1, perm)
        o_p = o.gather(1, perm)
        m_p = mask.gather(1, perm)
        n_valid = torch.sum(mask, dim=1)                    # [B]
        sort_size = (n_valid if max_sort == -1
                     else torch.clamp(n_valid, max=float(max_sort))
                     )[:, None, None]
        pos = torch.arange(length, dtype=o.dtype, device=o.device)
        disc = 1.0 / torch.log(pos + 2.0)
        k = (pos < trunc).to(o.dtype)
        maxdcg = torch.clamp(
            torch.sum((2.0 ** s_p - 1.0) * disc * k * m_p, dim=1),
            min=1e-12)
        pa, pb = pos[None, :, None], pos[None, None, :]
        valid = ((pa < pb) & (pa < sort_size)
                 & (m_p[:, :, None] > 0) & (m_p[:, None, :] > 0))
        disc_b_eff = torch.where(pb < sort_size, disc[None, None, :],
                                 torch.zeros((), dtype=o.dtype,
                                             device=o.device))
        dcgdif = ((2.0 ** s_p[:, :, None] - 2.0 ** s_p[:, None, :])
                  * (disc[None, :, None] - disc_b_eff))
        lam = (-torch.abs(dcgdif)
               * torch.sigmoid(o_p[:, None, :] - o_p[:, :, None])
               / maxdcg[:, None, None])
        lam = torch.where(valid, lam, torch.zeros_like(lam))
        gs = torch.sum(lam, dim=2) - torch.sum(lam, dim=1)  # sorted space
        inv = torch.argsort(perm, dim=1)
        grad = gs.gather(1, inv) * (g / b)
        return grad, torch.zeros_like(s), torch.zeros_like(mask), None, None


@register_layer
class LambdaCost(_SeqCostBase):
    """LambdaRank listwise ranking cost (reference: LambdaCost): each
    sequence is one query's documents.  The forward reports mean
    NDCG@NDCG_num; the backward injects the LambdaRank pair gradients."""

    kind = "lambda_cost"

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        o = inputs[0].reshape(inputs[0].shape[0], -1).float()
        s = inputs[1].reshape(o.shape).float()
        mask = masks[0]
        if mask is None:
            mask = torch.ones(o.shape, dtype=torch.float32, device=o.device)
        return _LambdaCost.apply(o, s, mask.float(),
                                 int(attrs.get("NDCG_num", 5)),
                                 int(attrs.get("max_sort_size", -1)))


@register_layer
class CrossEntropyOverBeamCost(_CostBase):
    """Globally normalised cross entropy over beam-search expansions
    (reference: CrossEntropyOverBeam.cpp), the JAX package's fixed-shape
    form: every expansion step e supplies candidate scores [B, P*K],
    selected candidate indices [B, K] (row-major r*K + c, -1 a dead slot,
    parent row idx // K) and the gold candidate [B]; the step where gold
    falls off the beam is picked per sequence by a one-hot select over
    the E steps, and the gold prefix then joins as an extra path.
    attrs: expansions E (inputs arrive as E [scores, selected, gold]
    triples)."""

    kind = "cross_entropy_over_beam"

    def apply(self, attrs, params, inputs, ctx):
        n_exp = int(attrs["expansions"])
        neg = -1e9
        b = inputs[0].shape[0]
        k = inputs[1].shape[1]
        dev = inputs[0].device
        s_prev = None
        g = torch.zeros((b,), dtype=torch.float32, device=dev)
        s_steps, g_steps, col_steps, in_beam_steps = [], [], [], []
        for e in range(n_exp):
            sc = inputs[3 * e].reshape(b, -1).float()
            sel = inputs[3 * e + 1].long().reshape(b, k)
            gold = inputs[3 * e + 2].long().reshape(b)
            valid = sel >= 0
            sel_c = torch.clamp(sel, 0, sc.shape[1] - 1)
            step_sc = sc.gather(1, sel_c)
            negs = torch.full_like(step_sc, neg)
            if s_prev is None:
                s_cur = torch.where(valid, step_sc, negs)
            else:
                parent = torch.clamp(sel_c // k, 0, k - 1)
                s_cur = torch.where(valid,
                                    step_sc + s_prev.gather(1, parent), negs)
            gold_c = torch.clamp(gold, 0, sc.shape[1] - 1)
            g = g + sc.gather(1, gold_c[:, None])[:, 0]
            hit = sel == gold[:, None]
            s_steps.append(s_cur)
            g_steps.append(g)
            col_steps.append(torch.argmax(hit.int(), dim=1))
            in_beam_steps.append(torch.any(hit, dim=1))
            s_prev = s_cur
        s_all = torch.stack(s_steps)                        # [E, B, K]
        g_all = torch.stack(g_steps)                        # [E, B]
        col_all = torch.stack(col_steps)                    # [E, B]
        alive = torch.cumprod(torch.stack(in_beam_steps).int(), dim=0)
        fell_off = alive[-1] == 0
        f_step = torch.clamp(torch.sum(alive, dim=0), max=n_exp - 1)
        onehot = (torch.arange(n_exp, device=dev)[:, None]
                  == f_step[None, :]).float()
        s_f = torch.einsum("eb,ebk->bk", onehot, s_all)
        g_f = torch.einsum("eb,eb->b", onehot, g_all)
        col_f = torch.sum(onehot * col_all.float(), dim=0).long()
        extra = torch.where(fell_off, g_f, torch.full_like(g_f, neg))
        scores = torch.cat([s_f, extra[:, None]], dim=1)    # [B, K+1]
        label = torch.where(fell_off, torch.full_like(col_f, k), col_f)
        logp = torch.log_softmax(
            torch.where(scores <= neg / 2,
                        torch.full_like(scores, -math.inf), scores), dim=1)
        nll = -logp.gather(1, label[:, None])[:, 0]
        return torch.mean(nll)
