"""Box utilities: IoU, SSD box coding and static-shape NMS (counterpart of
``paddle_tpu/ops/boxes.py``; plain PyTorch, since the JAX package has no
Pallas kernel here).

Reference kernels replaced: iou_similarity_op, box_coder_op (SSD
center-size coding with prior variances), multiclass_nms_op.

``nms`` is batched: every leading axis (images, classes) runs at once,
and the loop is ``min(max_out, N)`` rounds of argmax and suppress on the
device.  Nothing in it reads back to the host (no ``.item()``, no
boolean indexing), so a step that holds it runs without a sync.
"""

from __future__ import annotations

import torch


def box_area(boxes):
    """boxes [..., 4] as (x1, y1, x2, y2)."""
    return (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0))


def _iou(a, b):
    """IoU of broadcastable box tensors a [..., 4] and b [..., 4]."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a) + box_area(b) - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-10),
                       torch.zeros((), device=inter.device))


def iou_matrix(a, b):
    """a [..., N, 4], b [..., M, 4] -> IoU [..., N, M] (iou_similarity_op
    parity)."""
    return _iou(a[..., :, None, :], b[..., None, :, :])


def _center_size(boxes):
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return (w, h, (boxes[..., 0] + boxes[..., 2]) * 0.5,
            (boxes[..., 1] + boxes[..., 3]) * 0.5)


def encode_boxes(gt, priors, variances):
    """SSD center-size encoding (box_coder_op encode_center_size): gt and
    priors [..., 4] corner boxes, variances [4] or [..., 4] -> the loc
    targets [..., 4]."""
    pw, ph, pcx, pcy = _center_size(priors)
    gw = torch.clamp(gt[..., 2] - gt[..., 0], min=1e-6)
    gh = torch.clamp(gt[..., 3] - gt[..., 1], min=1e-6)
    gcx = (gt[..., 0] + gt[..., 2]) * 0.5
    gcy = (gt[..., 1] + gt[..., 3]) * 0.5
    return torch.stack([(gcx - pcx) / (pw * variances[..., 0]),
                        (gcy - pcy) / (ph * variances[..., 1]),
                        torch.log(gw / pw) / variances[..., 2],
                        torch.log(gh / ph) / variances[..., 3]], -1)


def decode_boxes(loc, priors, variances):
    """The inverse of ``encode_boxes`` (box_coder_op decode_center_size)."""
    pw, ph, pcx, pcy = _center_size(priors)
    cx = loc[..., 0] * variances[..., 0] * pw + pcx
    cy = loc[..., 1] * variances[..., 1] * ph + pcy
    w = torch.exp(loc[..., 2] * variances[..., 2]) * pw
    h = torch.exp(loc[..., 3] * variances[..., 3]) * ph
    return torch.stack([cx - w * 0.5, cy - h * 0.5,
                        cx + w * 0.5, cy + h * 0.5], -1)


def nms(boxes, scores, *, iou_threshold: float = 0.45,
        score_threshold: float = 0.0, max_out: int = 100):
    """Greedy NMS with a static output shape, batched over the leading
    axes.

    boxes [..., N, 4], scores [..., N] -> (indices [..., max_out] int64,
    valid [..., max_out] bool): the kept boxes by descending score, -1 and
    False past the last.  Each round takes the first maximum of the live
    scores (``jnp.argmax``'s tie order), keeps it if it is finite, and
    suppresses it and every live box whose IoU with it reaches the
    threshold."""
    lead, n = scores.shape[:-1], scores.shape[-1]
    dev = scores.device
    alive = scores > score_threshold
    neg_inf = torch.full((), float("-inf"), dtype=scores.dtype, device=dev)
    arange = torch.arange(n, device=dev)
    idxs = torch.full(lead + (max_out,), -1, dtype=torch.long, device=dev)
    valid = torch.zeros(lead + (max_out,), dtype=torch.bool, device=dev)
    for i in range(min(max_out, n)):
        masked = torch.where(alive, scores, neg_inf)
        best = torch.argmax(masked, -1, keepdim=True)            # [..., 1]
        ok = torch.gather(masked, -1, best) > neg_inf             # [..., 1]
        idxs[..., i:i + 1] = torch.where(ok, best, torch.full_like(best, -1))
        valid[..., i:i + 1] = ok
        winner = torch.gather(boxes, -2, best[..., None].expand(
            lead + (1, 4)))                                       # [..., 1, 4]
        suppress = (_iou(winner, boxes) >= iou_threshold) | (arange == best)
        alive = torch.where(ok, alive & ~suppress, alive)
    return idxs, valid
