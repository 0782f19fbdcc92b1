"""Detection layers: prior boxes, ROI pooling, the multibox loss and the
NMS output (counterpart of ``paddle_tpu/layers/detection.py``).

Reference: gserver/layers/PriorBox.cpp, ROIPoolLayer.cpp,
MultiBoxLossLayer.cpp, DetectionOutputLayer.cpp.  The shapes are the JAX
package's static ones: ground truth comes padded (boxes [G, 4], labels
[G] with -1 in the padding slots) and ``detection_output`` emits a fixed
[keep_top_k, 6] block a sample (label, score, x1, y1, x2, y2), padded
with label -1.  Where the JAX package maps one image at a time with
``jax.vmap``, the batch is a tensor axis here, and NMS runs over images
and classes at once (``ops/boxes.nms``).

Two orders follow the JAX package on the CPU exactly: both sorts are
stable (``torch.argsort(..., stable=True)``; ``-inf`` keys tie and keep
their index order), and the force-match gives a prior that is the best
of several ground truths to the largest of their indices, the last write
of JAX's scatter, resolved here by a max over the ground truths rather
than by the order of a scatter's duplicate writes, which CUDA leaves
undefined.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import LayerDef, register_layer
from paddle_tpu_torch.ops import boxes as box_ops


@register_layer
class PriorBoxLayer(LayerDef):
    """SSD prior boxes of a feature map (reference PriorBox.cpp): [priors,
    8] a sample, the 4 normalised corners and the 4 coding variances.
    Sizes are pixels of the image input, normalised by its width and
    height."""

    kind = "priorbox"

    @staticmethod
    def _per_cell(attrs):
        max_sizes = attrs.get("max_size", [])
        if max_sizes and len(max_sizes) != len(attrs["min_size"]):
            raise ValueError(
                f"priorbox: max_size ({len(max_sizes)}) must be empty or "
                f"match min_size ({len(attrs['min_size'])}) in length")
        n_ar = 1 + 2 * len(attrs.get("aspect_ratio", []))
        return len(attrs["min_size"]) * n_ar + len(max_sizes)

    def infer_shape(self, attrs, in_shapes):
        h, w = in_shapes[0][0], in_shapes[0][1]
        return (h * w * self._per_cell(attrs), 8)

    def apply(self, attrs, params, inputs, ctx):
        feat, image = inputs[0], inputs[1]
        b, h, w = feat.shape[0], feat.shape[1], feat.shape[2]
        dev = feat.device
        img_h, img_w = float(image.shape[1]), float(image.shape[2])
        min_sizes = [(ms / img_w, ms / img_h) for ms in attrs["min_size"]]
        max_sizes = [(ms / img_w, ms / img_h)
                     for ms in attrs.get("max_size", [])]
        whs = []
        for mw, mh in min_sizes:
            whs.append((mw, mh))
            for r in attrs.get("aspect_ratio", []):
                rs = float(r) ** 0.5
                whs.append((mw * rs, mh / rs))
                whs.append((mw / rs, mh * rs))
        for (mw, mh), (xw, xh) in zip(min_sizes, max_sizes):
            whs.append(((mw * xw) ** 0.5, (mh * xh) ** 0.5))
        cx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        cy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        cxg, cyg = torch.meshgrid(cx, cy, indexing="xy")       # [h, w]
        boxes = torch.stack([torch.stack([cxg - bw / 2, cyg - bh / 2,
                                          cxg + bw / 2, cyg + bh / 2], -1)
                             for bw, bh in whs], 2).reshape(-1, 4)
        if attrs.get("clip", True):
            boxes = torch.clamp(boxes, 0.0, 1.0)
        # device fills, not a copy from the host: nothing here waits on
        # the card (a captured graph can hold it)
        var = torch.stack([torch.full((), float(v), device=dev) for v in
                           attrs.get("variance", [0.1, 0.1, 0.2, 0.2])])
        out = torch.cat([boxes, var.expand(boxes.shape)], -1)
        return out[None].expand((b,) + tuple(out.shape))


@register_layer
class RoiPoolLayer(LayerDef):
    """ROI max pooling (reference ROIPoolLayer.cpp, fluid roi_pool_op):
    feature map [B, H, W, C], rois [B, R, 4] (x1, y1, x2, y2 in image
    coordinates, ``spatial_scale`` to the map's) -> [B, R, ph, pw, C]; an
    empty bin is 0."""

    kind = "roi_pool"

    def infer_shape(self, attrs, in_shapes):
        return (in_shapes[1][0], attrs["pooled_height"],
                attrs["pooled_width"], in_shapes[0][2])

    def apply(self, attrs, params, inputs, ctx):
        feat, rois = inputs
        if rois.ndim != 3 or rois.shape[-1] != 4:
            raise ValueError(f"roi_pool wants rois [B, R, 4], got "
                             f"{tuple(rois.shape)}")
        ph, pw = attrs["pooled_height"], attrs["pooled_width"]
        h, w = feat.shape[1], feat.shape[2]
        dev = feat.device
        r = rois.float() * attrs.get("spatial_scale", 1.0)     # [B, R, 4]
        x1 = torch.clamp(torch.floor(r[..., 0]), 0, w - 1)
        y1 = torch.clamp(torch.floor(r[..., 1]), 0, h - 1)
        x2 = torch.minimum(torch.maximum(torch.ceil(r[..., 2]), x1 + 1),
                           torch.full((), float(w), device=dev))
        y2 = torch.minimum(torch.maximum(torch.ceil(r[..., 3]), y1 + 1),
                           torch.full((), float(h), device=dev))
        bin_w = ((x2 - x1) / pw)[..., None]                    # [B, R, 1]
        bin_h = ((y2 - y1) / ph)[..., None]
        by = torch.arange(ph, dtype=torch.float32, device=dev)
        bx = torch.arange(pw, dtype=torch.float32, device=dev)
        ys = torch.arange(h, dtype=torch.float32, device=dev)
        xs = torch.arange(w, dtype=torch.float32, device=dev)
        y_lo = y1[..., None] + by * bin_h                      # [B, R, ph]
        y_hi = y1[..., None] + (by + 1) * bin_h
        x_lo = x1[..., None] + bx * bin_w                      # [B, R, pw]
        x_hi = x1[..., None] + (bx + 1) * bin_w
        m_y = ((ys >= torch.floor(y_lo)[..., None])
               & (ys < torch.ceil(y_hi)[..., None]))           # [B,R,ph,H]
        m_x = ((xs >= torch.floor(x_lo)[..., None])
               & (xs < torch.ceil(x_hi)[..., None]))           # [B,R,pw,W]
        mask = m_y[:, :, :, None, :, None] & m_x[:, :, None, :, None, :]
        fmap = feat[:, None, None, None]                   # [B,1,1,1,H,W,C]
        sel = torch.where(mask[..., None], fmap,
                          torch.full((), float("-inf"), dtype=feat.dtype,
                                     device=dev))
        v = torch.amax(sel, (4, 5))                        # [B,R,ph,pw,C]
        return torch.where(torch.isfinite(v), v,
                           torch.zeros((), dtype=v.dtype, device=dev))


def _smooth_l1(x):
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


@register_layer
class MultiBoxLossLayer(LayerDef):
    """The SSD loss (reference MultiBoxLossLayer.cpp): priors matched to
    ground truth (IoU at least ``overlap_threshold``, and each valid
    ground truth's best prior forced), smooth-L1 on the positives' coded
    boxes, softmax cross-entropy on the positives and the hardest
    ``neg_pos_ratio`` negatives a positive, over max(positives, 1), then
    the batch mean.

    inputs: loc [P * 4] or [P, 4], conf [P, C], priors [P, 8], gt boxes
    [G, 4], gt labels [G] (-1 pads; 0 the background id)."""

    kind = "multibox_loss"

    def infer_shape(self, attrs, in_shapes):
        return ()

    def apply(self, attrs, params, inputs, ctx):
        loc, conf, priors, gt_box, gt_label = inputs
        b, p = priors.shape[0], priors.shape[1]
        dev = priors.device
        loc = loc.reshape(b, p, 4)
        bg = attrs.get("background_id", 0)
        gtl = gt_label.reshape(b, -1).to(torch.int64)          # [B, G]
        gtb = gt_box.reshape(b, -1, 4)
        g = gtl.shape[1]
        pboxes, pvar = priors[..., :4], priors[:, :1, 4:]
        valid_gt = gtl >= 0
        with torch.no_grad():
            ious = torch.where(valid_gt[:, None, :],
                               box_ops.iou_matrix(pboxes, gtb),
                               torch.full((), -1.0, device=dev))  # [B,P,G]
            best_iou, best_gt = torch.max(ious, 2)             # [B, P]
            best_prior = torch.where(valid_gt, torch.argmax(ious, 1),
                                     torch.full((), p, device=dev))  # [B, G]
            hit = best_prior[:, None, :] == torch.arange(
                p, device=dev)[None, :, None]                  # [B, P, G]
            winner = torch.amax(torch.where(
                hit, torch.arange(g, device=dev),
                torch.full((), -1, device=dev)), 2)            # [B, P]
            forced = winner >= 0
            best_gt = torch.where(forced, winner, best_gt)
            pos = (best_iou >= attrs.get("overlap_threshold", 0.5)) | forced
            tgt_label = torch.where(pos, torch.gather(gtl, 1, best_gt),
                                    torch.full((), bg, device=dev))
            n_pos = pos.sum(1)
        matched = torch.gather(gtb, 1, best_gt[..., None].expand(b, p, 4))
        enc = box_ops.encode_boxes(matched, pboxes, pvar)
        loc_loss = torch.sum(_smooth_l1(loc - enc).sum(-1) * pos, 1)
        ce = -torch.gather(torch.log_softmax(conf, -1), 2,
                           tgt_label[..., None])[..., 0]      # [B, P]
        with torch.no_grad():
            ratio = attrs.get("neg_pos_ratio", 3.0)
            n_neg = torch.minimum((ratio * n_pos.float()).to(torch.int64),
                                  (~pos).sum(1))
            neg_ce = torch.where(pos, torch.full((), float("-inf"),
                                                 device=dev), ce)
            order = torch.argsort(-neg_ce, dim=1, stable=True)
            rank = torch.empty_like(order).scatter_(
                1, order, torch.arange(p, device=dev).expand(b, p))
            neg = ~pos & (rank < n_neg[:, None])
        conf_loss = torch.sum(ce * (pos | neg), 1)
        losses = (loc_loss + conf_loss) / torch.clamp(n_pos, min=1)
        return losses.mean()


@register_layer
class DetectionOutputLayer(LayerDef):
    """Decoding and per-class NMS (reference DetectionOutputLayer.cpp,
    multiclass_nms_op): [keep_top_k, 6] a sample, (label, score, box),
    label -1 on padding rows; the background class gets no NMS lane."""

    kind = "detection_output"

    def infer_shape(self, attrs, in_shapes):
        return (attrs.get("keep_top_k", 100), 6)

    def apply(self, attrs, params, inputs, ctx):
        loc, conf, priors = inputs
        b, p = priors.shape[0], priors.shape[1]
        dev = priors.device
        loc = loc.reshape(b, p, 4)
        num_classes = conf.shape[-1]
        want = attrs.get("num_classes")
        if want is not None and want != num_classes:
            raise ValueError(
                f"detection_output num_classes={want} but conf input is "
                f"{num_classes}-wide")
        keep = attrs.get("keep_top_k", 100)
        nms_k = attrs.get("nms_top_k", keep)
        bg = attrs.get("background_id", 0)
        boxes = box_ops.decode_boxes(loc, priors[..., :4],
                                     priors[:, :1, 4:])        # [B, P, 4]
        probs = torch.softmax(conf, -1)                        # [B, P, C]
        # the classes but the background, by slices: no index tensor
        # copied from the host
        scores = torch.cat([probs[..., :bg], probs[..., bg + 1:]],
                           -1).transpose(1, 2)                 # [B, K, P]
        ar = torch.arange(num_classes, dtype=torch.float32, device=dev)
        cls = torch.cat([ar[:bg], ar[bg + 1:]])
        k = cls.shape[0]
        lanes = boxes[:, None].expand(b, k, p, 4)
        with torch.no_grad():
            idx, valid = box_ops.nms(
                lanes.detach(), scores.detach(),
                iou_threshold=attrs.get("nms_threshold", 0.45),
                score_threshold=attrs.get("confidence_threshold", 0.01),
                max_out=nms_k)
        sel = torch.clamp(idx, 0, p - 1)                       # [B, K, nk]
        kept = torch.where(valid, torch.gather(scores, 2, sel),
                           torch.full((), -1.0, device=dev))
        bxs = torch.gather(lanes, 2, sel[..., None].expand(
            sel.shape + (4,)))
        labels = cls[None, :, None].expand(sel.shape).reshape(b, -1)
        kept = kept.reshape(b, -1)
        bxs = bxs.reshape(b, -1, 4)
        pad = max(0, keep - kept.shape[1])
        if pad:
            labels = torch.cat([labels, torch.full(
                (b, pad), -1.0, device=dev)], 1)
            kept = torch.cat([kept, torch.full((b, pad), -1.0,
                                               device=dev)], 1)
            bxs = torch.cat([bxs, torch.zeros((b, pad, 4), device=dev)], 1)
        top = torch.argsort(-kept, dim=1, stable=True)[:, :keep]
        top_scores = torch.gather(kept, 1, top)
        lab = torch.where(top_scores > 0, torch.gather(labels, 1, top),
                          torch.full((), -1.0, device=dev))
        return torch.cat([lab[..., None], top_scores[..., None],
                          torch.gather(bxs, 1, top[..., None].expand(
                              top.shape + (4,)))], -1)
