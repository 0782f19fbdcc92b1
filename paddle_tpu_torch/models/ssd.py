"""SSD, the single-shot detector (counterpart of ``paddle_tpu/models/ssd.py``;
reference: gserver/layers/{PriorBox,MultiBoxLoss,DetectionOutput}.cpp over
a conv backbone): four conv + batch norm (relu) + pool blocks, loc and
conf heads on the last two maps, the priors of both scales concatenated
into one [P, 4] / [P, C] / [P, 8] set, the multibox loss and the NMS
output.  Under ``fused_bn_impl="pallas"`` the four relu batch norms take
the CUDA statistic kernels 7a and 7b on the card.
"""

from __future__ import annotations

from paddle_tpu_torch import data_type, layer


def build(image_size: int = 64, num_classes: int = 4, max_gt: int = 4,
          is_infer: bool = False):
    """Returns (cost, detections), or the detections alone with
    ``is_infer``.  Feeds: image [B, H, W, 3]; training adds gt_box [B,
    max_gt * 4] and gt_label [B, max_gt] (-1 pads)."""
    img = layer.data("image",
                     data_type.dense_vector(image_size * image_size * 3),
                     height=image_size, width=image_size)

    def block(x, nf, name):
        c = layer.img_conv(x, filter_size=3, num_filters=nf, padding=1,
                           act=None, bias_attr=False, name=name + "_conv")
        b = layer.batch_norm(c, act="relu", name=name + "_bn")
        return layer.img_pool(b, pool_size=2, stride=2,
                              name=name + "_pool")

    c1 = block(img, 16, "ssd1")
    c2 = block(c1, 32, "ssd2")
    c3 = block(c2, 64, "ssd3")           # stride 8
    c4 = block(c3, 64, "ssd4")           # stride 16

    def _cells(s, n_pools):
        for _ in range(n_pools):         # the pools are ceil-mode
            s = -(-s // 2)
        return s

    aspect = [2.0]
    scales = [(c3, _cells(image_size, 3), 0.2),
              (c4, _cells(image_size, 4), 0.45)]
    # a cell: min, (ar, 1/ar) an aspect, and the sqrt(min * max) box
    n_priors = 1 + 2 * len(aspect) + 1

    locs, confs, priors = [], [], []
    for i, (feat, cells, scale) in enumerate(scales):
        m = scale * image_size
        pb = layer.priorbox(feat, img, min_size=[m], max_size=[2 * m],
                            aspect_ratio=aspect, name=f"priorbox{i}")
        p_i = cells * cells * n_priors
        lo = layer.img_conv(feat, filter_size=3,
                            num_filters=n_priors * 4, padding=1, act=None,
                            name=f"head{i}_loc")
        cf = layer.img_conv(feat, filter_size=3,
                            num_filters=n_priors * num_classes, padding=1,
                            act=None, name=f"head{i}_conf")
        locs.append(layer.reshape(lo, (p_i, 4)))
        confs.append(layer.reshape(cf, (p_i, num_classes)))
        priors.append(pb)
    loc = layer.concat(locs, axis=0, name="ssd_loc")
    conf = layer.concat(confs, axis=0, name="ssd_conf")
    prior = layer.concat(priors, axis=0, name="ssd_priors")

    det = layer.detection_output(loc, conf, prior,
                                 num_classes=num_classes,
                                 name="detections")
    if is_infer:
        return det

    gt_box = layer.data("gt_box",
                        data_type.dense_vector(4 * max_gt))
    gt_box_r = layer.reshape(gt_box, (max_gt, 4))
    gt_label = layer.data("gt_label", data_type.dense_vector(max_gt))
    cost = layer.multibox_loss(loc, conf, prior, gt_label, gt_box_r,
                               name="ssd_cost")
    return cost, det
