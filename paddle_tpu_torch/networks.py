"""Composite network helpers: the image ones (conv + pool, conv + BN +
pool, the VGG block and nets, the separable conv), the recurrent ones
(whole-sequence layers and the explicit ``recurrent_group`` units),
additive, dot-product and multi-head attention, the text conv block and
the legacy ``inputs`` / ``outputs`` declarations.  They compose DSL
layers only; names and attributes are the JAX package's, so both write
the same JSON.
"""

from __future__ import annotations

from paddle_tpu_torch import layer
from paddle_tpu_torch.core.ir import LayerOutput


def _uniq(base: str) -> str:
    """auto-unique default name for composite helpers (two unnamed
    instances must not collide)."""
    idx = LayerOutput._COUNTERS.get("net:" + base, 0)
    LayerOutput._COUNTERS["net:" + base] = idx + 1
    return f"{base}_{idx}"


def simple_img_conv_pool(input, filter_size, num_filters, pool_size,
                         pool_stride=None, act=None, pool_type="max",
                         padding=None, name=None):
    conv = layer.img_conv(
        input=input, filter_size=filter_size, num_filters=num_filters,
        padding=(padding if padding is not None else filter_size // 2),
        act=act, name=name and name + "_conv")
    return layer.img_pool(input=conv, pool_size=pool_size,
                          stride=pool_stride or pool_size,
                          pool_type=pool_type, name=name and name + "_pool")


def img_conv_bn_pool(input, filter_size, num_filters, pool_size,
                     pool_stride=None, act="relu", pool_type="max",
                     padding=None, name=None):
    conv = layer.img_conv(
        input=input, filter_size=filter_size, num_filters=num_filters,
        padding=(padding if padding is not None else filter_size // 2),
        act=None, bias_attr=False, name=name and name + "_conv")
    bn = layer.batch_norm(input=conv, act=act, name=name and name + "_bn")
    return layer.img_pool(input=bn, pool_size=pool_size,
                          stride=pool_stride or pool_size,
                          pool_type=pool_type, name=name and name + "_pool")


def img_conv_group(input, conv_num_filter, pool_size, num_channels=None,
                   conv_padding=1, conv_filter_size=3, conv_act="relu",
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=None, pool_type="max", name=None):
    """A stack of convs (each optionally with batch norm and dropout) and
    one pool: the VGG block.  Each per-conv argument is a value for all or
    a list of one per conv."""
    if isinstance(conv_num_filter, int):
        conv_num_filter = [conv_num_filter]
    n = len(conv_num_filter)

    def each(v):
        return v if isinstance(v, (list, tuple)) else [v] * n

    pad, fsz = each(conv_padding), each(conv_filter_size)
    bn, dr = each(conv_with_batchnorm), each(conv_batchnorm_drop_rate)
    tmp = input
    for i in range(n):
        tmp = layer.img_conv(input=tmp, filter_size=fsz[i],
                             num_filters=conv_num_filter[i],
                             padding=pad[i],
                             act=None if bn[i] else conv_act,
                             bias_attr=not bn[i])
        if bn[i]:
            tmp = layer.batch_norm(input=tmp, act=conv_act)
            if dr[i] > 0:
                tmp = layer.dropout(tmp, rate=dr[i])
    return layer.img_pool(input=tmp, pool_size=pool_size,
                          stride=pool_stride or pool_size,
                          pool_type=pool_type, name=name)


def img_separable_conv(input, num_channels=None, num_out_channels=None,
                       filter_size=3, stride=1, padding=None,
                       depth_multiplier=1, act="relu", name=None):
    """depthwise (a conv with groups = C) then pointwise conv."""
    shape = input.attrs.get("shape")
    c = (num_channels or (shape[-1] if shape and len(shape) == 3 else None)
         or input.attrs.get("num_filters"))
    if c is None:
        raise ValueError(
            "img_separable_conv: cannot infer num_channels from input "
            f"layer {input.name!r}; pass num_channels explicitly")
    dw = layer.img_conv(input=input, filter_size=filter_size,
                        num_filters=c * depth_multiplier, groups=c,
                        stride=stride,
                        padding=(padding if padding is not None
                                 else filter_size // 2),
                        act=None, name=name and name + "_dw")
    return layer.img_conv(input=dw, filter_size=1,
                          num_filters=num_out_channels or c,
                          act=act, name=name and name + "_pw")


def small_vgg(input_image, num_channels=3, num_classes=10, name=None):
    """the cifar-10 VGG of the image benchmarks: four conv groups with
    batch norm and dropout, then two fc layers."""
    def block(ipt, num_filter, groups, drops):
        return img_conv_group(ipt, conv_num_filter=[num_filter] * groups,
                              pool_size=2,
                              conv_with_batchnorm=True,
                              conv_batchnorm_drop_rate=drops,
                              pool_type="max")

    tmp = block(input_image, 64, 2, [0.3, 0.0])
    tmp = block(tmp, 128, 2, [0.4, 0.0])
    tmp = block(tmp, 256, 3, [0.4, 0.4, 0.0])
    tmp = block(tmp, 512, 3, [0.4, 0.4, 0.0])
    tmp = layer.img_pool(input=tmp, pool_size=2, stride=2)
    tmp = layer.dropout(tmp, rate=0.5)
    tmp = layer.fc(input=tmp, size=512, act=None)
    tmp = layer.batch_norm(input=tmp, act="relu")
    tmp = layer.dropout(tmp, rate=0.5)
    return layer.fc(input=tmp, size=num_classes, act="softmax")


def vgg_16_network(input_image, num_channels=3, num_classes=1000):
    """VGG-16 without batch norm: five conv groups, two fc 4096 with
    dropout, softmax."""
    def block(ipt, num_filter, groups):
        return img_conv_group(ipt, conv_num_filter=[num_filter] * groups,
                              pool_size=2, pool_type="max")

    tmp = block(input_image, 64, 2)
    tmp = block(tmp, 128, 2)
    tmp = block(tmp, 256, 3)
    tmp = block(tmp, 512, 3)
    tmp = block(tmp, 512, 3)
    tmp = layer.fc(input=tmp, size=4096, act="relu")
    tmp = layer.dropout(tmp, rate=0.5)
    tmp = layer.fc(input=tmp, size=4096, act="relu")
    tmp = layer.dropout(tmp, rate=0.5)
    return layer.fc(input=tmp, size=num_classes, act="softmax")


def simple_lstm(input, size, reverse=False, act="tanh", gate_act="sigmoid",
                name=None):
    """fc projection to 4*size then lstmemory (reference: simple_lstm)."""
    proj = layer.fc(input=input, size=size * 4, act=None, bias_attr=False,
                    name=name and name + "_proj")
    return layer.lstmemory(input=proj, reverse=reverse, act=act,
                           gate_act=gate_act, name=name)


def simple_gru(input, size, reverse=False, act="tanh", gate_act="sigmoid",
               name=None):
    proj = layer.fc(input=input, size=size * 3, act=None, bias_attr=False,
                    name=name and name + "_proj")
    return layer.grumemory(input=proj, reverse=reverse, act=act,
                           gate_act=gate_act, name=name)


def bidirectional_lstm(input, size, return_seq=True, name=None):
    """fwd + bwd lstm concat (reference: bidirectional_lstm)."""
    fwd = simple_lstm(input, size, reverse=False,
                      name=name and name + "_fw")
    bwd = simple_lstm(input, size, reverse=True,
                      name=name and name + "_bw")
    if return_seq:
        return layer.concat([fwd, bwd], name=name)
    return layer.concat([layer.last_seq(fwd), layer.first_seq(bwd)],
                        name=name)


def bidirectional_gru(input, size, return_seq=True, fused=False,
                      name=None):
    """fused=True runs both directions in one loop (the bigru layer)."""
    if fused:
        nm = name or _uniq("bigru")
        pf = layer.fc(input=input, size=size * 3, act=None,
                      bias_attr=False, name=nm + "_fw_proj")
        pb = layer.fc(input=input, size=size * 3, act=None,
                      bias_attr=False, name=nm + "_bw_proj")
        if return_seq:
            return layer.bigru(pf, pb, name=nm)
        # fwd last | bwd first - matches the unfused composition; the
        # caller-visible name stays on the pooled output like unfused
        out = layer.bigru(pf, pb, name=nm + "_seq")
        return layer.concat(
            [layer.last_seq(layer.slice(out, 0, size)),
             layer.first_seq(layer.slice(out, size, 2 * size))],
            name=nm)
    fwd = simple_gru(input, size, reverse=False, name=name and name + "_fw")
    bwd = simple_gru(input, size, reverse=True, name=name and name + "_bw")
    if return_seq:
        return layer.concat([fwd, bwd], name=name)
    return layer.concat([layer.last_seq(fwd), layer.first_seq(bwd)],
                        name=name)


def simple_attention(encoded_sequence, encoded_proj, decoder_state,
                     transform_act="tanh", name=None, fused=False):
    """additive (Bahdanau) attention:
    score_t = v . act(enc_proj_t + W s); context = sum_t softmax(score)_t
    enc_t.  ``fused=True`` is one bahdanau_attention layer (tanh only;
    its parameters are ``<name>.w_dp`` / ``<name>.v``); else the
    composite of fc, expand, addto, seq_softmax, seq_scale and pooling
    under the composite's fc names."""
    if fused:
        if transform_act != "tanh":
            raise ValueError(
                f"fused simple_attention supports transform_act='tanh' "
                f"only, got {transform_act!r}")
        return layer.bahdanau_attention(encoded_sequence, encoded_proj,
                                        decoder_state, name=name)
    decoder_proj = layer.fc(input=decoder_state,
                            size=encoded_proj.size, act=None,
                            bias_attr=False,
                            name=name and name + "_dec_proj")
    expanded = layer.expand(decoder_proj, encoded_proj,
                            name=name and name + "_expand")
    combined = layer.addto([encoded_proj, expanded], act=transform_act,
                           name=name and name + "_combine")
    scores = layer.fc(input=combined, size=1, act=None, bias_attr=False,
                      name=name and name + "_score")
    weights = layer.seq_softmax(scores, name=name and name + "_weight")
    scaled = layer.seq_scale(weights, encoded_sequence,
                             name=name and name + "_scale")
    return layer.pooling(scaled, pooling_type="sum",
                         name=name and name + "_context")


def multi_head_attention(query, key, value, head_num, key_proj_size=None,
                         value_proj_size=None, name=None):
    """one fused multi_head_attention layer (the flash kernel on the card)
    in place of per-head fc slices and a sequence softmax.  The fused
    layer uses ONE projection width; distinct key / value projection
    sizes raise rather than build a silently different model."""
    size = value_proj_size or value.size
    if key_proj_size is not None and key_proj_size != size:
        raise ValueError(
            f"fused multi_head_attention uses one projection width; "
            f"key_proj_size={key_proj_size} != value size {size}")
    return layer.multi_head_attention(
        query, key, value, size=size, num_heads=head_num, name=name)


def dot_product_attention(encoded_sequence, attended_sequence, decoder_state,
                          name=None):
    """reference: networks.py:1498 — scores by dot(enc_t, state)."""
    expanded = layer.expand(decoder_state, encoded_sequence,
                            name=name and name + "_expand")
    scores = layer.seq_dot(encoded_sequence, expanded,
                           name=name and name + "_score")
    weights = layer.seq_softmax(scores, name=name and name + "_weight")
    scaled = layer.seq_scale(weights, attended_sequence,
                             name=name and name + "_scale")
    return layer.pooling(scaled, pooling_type="sum",
                         name=name and name + "_context")


def lstmemory_unit(input, out_memory=None, size=None, act="tanh",
                   gate_act="sigmoid", state_act="tanh", name=None,
                   input_proj_bias_attr=None):
    """one LSTM step for use inside recurrent_group (reference:
    networks.py lstmemory_unit — fc of [input, out_mem] then lstm_step
    with a state memory; here the state memory is the house [h|c]
    combined convention of lstm_step_layer)."""
    size = size or input.size // 4
    nm = name or _uniq("lstmemory_unit")
    if out_memory is None:
        out_memory = layer.memory(name=nm, size=size)
    state_mem = layer.memory(name=nm + "_step", size=2 * size)
    proj = layer.fc(input=[input, out_memory], size=size * 4, act=None,
                    bias_attr=input_proj_bias_attr,
                    name=nm + "_input_proj")
    step = layer.lstm_step_layer(input=proj, state_mem=state_mem,
                                 size=size, act=act, gate_act=gate_act,
                                 state_act=state_act, name=nm + "_step")
    return layer.get_output(step, "state", name=nm)


def lstmemory_group(input, size=None, reverse=False, act="tanh",
                    gate_act="sigmoid", name=None):
    """LSTM as an explicit recurrent_group over steps (reference:
    networks.py lstmemory_group) — same math as lstmemory but the step is
    user-visible for attention-style extensions.

    The input-side 4h projection is hoisted OUT of the loop (one [B*T]
    matmul); only the recurrent out_memory projection runs per step
    (the same hoisting simple_lstm and the reference's fc-then-lstmemory
    idiom do)."""
    size = size or input.size // 4
    nm = name or _uniq("lstmemory_group")
    in_proj = layer.fc(input=input, size=size * 4, act=None,
                       bias_attr=False, name=nm + "_in_proj")

    def step(inp_proj):
        out_memory = layer.memory(name=nm, size=size)
        state_mem = layer.memory(name=nm + "_step", size=2 * size)
        rec = layer.fc(input=out_memory, size=size * 4, act=None,
                       bias_attr=True, name=nm + "_rec_proj")
        gates = layer.addto([inp_proj, rec])
        s = layer.lstm_step_layer(input=gates, state_mem=state_mem,
                                  size=size, act=act, gate_act=gate_act,
                                  name=nm + "_step")
        return layer.get_output(s, "state", name=nm)

    return layer.recurrent_group(step=step, input=in_proj,
                                 reverse=reverse, name=nm + "_rg")


def gru_unit(input, size=None, memory_boot=None, act="tanh",
             gate_act="sigmoid", name=None):
    """one GRU step inside recurrent_group (reference: networks.py
    gru_unit)."""
    size = size or input.size // 3
    nm = name or _uniq("gru_unit")
    out_mem = layer.memory(name=nm, size=size, boot_layer=memory_boot)
    return layer.gru_step_layer(input=input, output_mem=out_mem, size=size,
                                act=act, gate_act=gate_act, name=nm)


def gru_group(input, size=None, memory_boot=None, reverse=False,
              act="tanh", gate_act="sigmoid", name=None):
    """GRU as an explicit recurrent_group (reference: networks.py
    gru_group). `input` must be the 3h-wide gate projection."""
    size = size or input.size // 3
    nm = name or _uniq("gru_group")

    def step(inp):
        return gru_unit(inp, size=size, memory_boot=memory_boot, act=act,
                        gate_act=gate_act, name=nm)

    return layer.recurrent_group(step=step, input=input, reverse=reverse,
                                 name=nm + "_rg")


def simple_gru2(input, size, reverse=False, act="tanh", gate_act="sigmoid",
                name=None):
    """fc + gru_group (reference: simple_gru2 — same math as simple_gru,
    different composition route; kept for config compatibility)."""
    nm = name or _uniq("simple_gru2")
    proj = layer.fc(input=input, size=size * 3, act=None, bias_attr=False,
                    name=nm + "_proj")
    return gru_group(proj, size=size, reverse=reverse, act=act,
                     gate_act=gate_act, name=nm)



def sequence_conv_pool(input, context_len, hidden_size, context_start=None,
                       pool_type="max", context_proj_param_attr=None,
                       fc_param_attr=None, fc_act=None, name=None):
    """context projection + fc + seq pool — text-conv block (reference:
    networks.py sequence_conv_pool; fluid twin nets.sequence_conv_pool)."""
    ctx = layer.context_projection(
        input, context_len=context_len,
        context_start=(context_start if context_start is not None
                       else -(context_len // 2)))
    fc = layer.fc(input=ctx, size=hidden_size, act=fc_act,
                  param_attr=fc_param_attr, name=name and name + "_fc")
    return layer.pooling(input=fc, pooling_type=pool_type,
                         name=name and name + "_pool")


text_conv_pool = sequence_conv_pool



def inputs(layers_, *args):
    """declare the feed order: the names of the input layers (DataFeeder
    takes an explicit order, so this only records names)."""
    all_in = ([layers_] if not isinstance(layers_, (list, tuple))
              else list(layers_)) + list(args)
    return [getattr(l, "name", l) for l in all_in]


#: last outputs() call, read by the CLI when a legacy config declares
#: its cost via outputs(loss) instead of a `cost` variable
_DECLARED_OUTPUTS: list = []


def outputs(layers_, *args):
    """declare output layers (reference: networks.py outputs() writes the
    proto output_layer_names; the CLI reads the declaration when the
    config has no `cost` variable)."""
    all_out = ([layers_] if not isinstance(layers_, (list, tuple))
               else list(layers_)) + list(args)
    _DECLARED_OUTPUTS[:] = all_out
    return all_out
