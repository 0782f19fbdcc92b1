"""Composite networks (reference ``python/paddle/v2/fluid/nets.py``)."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.fluid import layers


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act=None, param_attr=None,
                         pool_type="max"):
    """conv2d + pool2d (reference ``nets.py:24``)."""
    conv_out = layers.conv2d(input=input, num_filters=num_filters,
                             filter_size=filter_size, param_attr=param_attr,
                             act=act)
    return layers.pool2d(input=conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max"):
    """Stacked convs + one pool (reference ``nets.py:55``, the VGG block)."""
    tmp = input
    if not isinstance(conv_num_filter, (list, tuple)):
        conv_num_filter = [conv_num_filter]
    if not isinstance(conv_with_batchnorm, (list, tuple)):
        conv_with_batchnorm = [conv_with_batchnorm] * len(conv_num_filter)
    if not isinstance(conv_batchnorm_drop_rate, (list, tuple)):
        conv_batchnorm_drop_rate = \
            [conv_batchnorm_drop_rate] * len(conv_num_filter)
    for i, nf in enumerate(conv_num_filter):
        local_act = conv_act if not conv_with_batchnorm[i] else None
        tmp = layers.conv2d(input=tmp, num_filters=nf,
                            filter_size=conv_filter_size,
                            padding=conv_padding, act=local_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            if conv_batchnorm_drop_rate[i] > 0:
                tmp = layers.dropout(tmp, conv_batchnorm_drop_rate[i])
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_stride=pool_stride, pool_type=pool_type)


def glu(input, dim=-1):
    """Gated linear unit: split + sigmoid gate (reference ``nets.py:130``)."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled-dot attention over [batch, len, d] tensors
    (reference ``nets.py:162``)."""
    d_key = keys.shape[-1] // num_heads

    def _split_heads(x):
        if num_heads == 1:
            return x
        b, t, d = x.shape[0], x.shape[1], x.shape[2]
        r = layers.reshape(x, [-1 if b < 0 else b, t, num_heads,
                               d // num_heads])
        return layers.transpose(r, [0, 2, 1, 3])

    def _merge_heads(x):
        if num_heads == 1:
            return x
        t = layers.transpose(x, [0, 2, 1, 3])
        return layers.reshape(t, [-1, t.shape[1],
                                  t.shape[2] * t.shape[3]])

    q, k, v = _split_heads(queries), _split_heads(keys), _split_heads(values)
    scaled_q = layers.scale(q, scale=float(d_key ** -0.5))
    logits = layers.matmul(scaled_q, k, transpose_y=True)
    weights = layers.softmax(logits)
    if dropout_rate > 0.0:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    ctx = layers.matmul(weights, v)
    return _merge_heads(ctx)
