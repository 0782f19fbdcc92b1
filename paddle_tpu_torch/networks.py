"""Composite network helpers: the recurrent ones and additive attention
(the part of ``paddle_tpu/networks.py`` the ported layers support).  They
compose DSL layers only; names and attributes are the JAX package's, so
both write the same JSON.
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
