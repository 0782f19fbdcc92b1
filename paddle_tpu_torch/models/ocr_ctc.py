"""OCR with CTC (counterpart of ``paddle_tpu/models/ocr_ctc.py``; the
reference's warp-ctc demo, models/scene-text-recognition): a conv and a
pool, the feature map's columns as a sequence (``block_expand``), a GRU
each way, and CTC over the frame logits.  At ``hidden % 128 == 0`` both
GRUs take the CUDA GRU step kernel on the card, one call a column.
"""

from __future__ import annotations

import paddle_tpu_torch as paddle
from paddle_tpu_torch import layer


def build(image_h: int = 16, image_w: int = 64, num_channels: int = 1,
          num_classes: int = 10, hidden: int = 64):
    """Feeds: image (H * W * C), label (a digit-id sequence); the blank is
    ``num_classes``.  Returns (cost, frame logits)."""
    img = layer.data(
        "image",
        paddle.data_type.dense_vector(image_h * image_w * num_channels),
        height=image_h, width=image_w)
    label = layer.data(
        "label",
        paddle.data_type.integer_value_sequence(num_classes, max_len=8))

    conv = layer.img_conv(img, filter_size=3, num_filters=16, padding=1,
                          stride=1, act="relu")
    pooled = layer.img_pool(conv, pool_size=2, stride=2)
    # the columns are the time axis (blocks of full height, width 1)
    cols = layer.block_expand(pooled, block_x=1, block_y=image_h // 2)
    proj = layer.fc(cols, size=3 * hidden, act=None, bias_attr=False)
    gru_f = layer.grumemory(proj, name="gru_f")
    proj_b = layer.fc(cols, size=3 * hidden, act=None, bias_attr=False)
    gru_b = layer.grumemory(proj_b, reverse=True, name="gru_b")
    feat = layer.concat([gru_f, gru_b])
    frames = layer.fc(feat, size=num_classes + 1, act=None,
                      name="frame_logits")
    cost = layer.ctc(frames, label, blank=num_classes, name="cost")
    return cost, frames
