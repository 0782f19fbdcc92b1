"""Recurrent layers: simple RNN, LSTM, GRU, the GRU and LSTM steps of
recurrent groups, and the fused bidirectional GRU (counterpart of
``paddle_tpu/layers/recurrent.py``; ``MDLstmemoryLayer`` is not ported
yet).

Where the JAX package runs each recurrence as one ``lax.scan`` over a
time-major tensor, here ``_scan_time_major`` is an eager loop over T under
autograd.  Masking is the JAX package's: a pad step freezes the state, so
the output at T-1 is the state at each sequence's true end, and a reverse
scan walks T-1 down to 0, writing each step's output at its own index as
``lax.scan(reverse=True)`` does.

Routing, exactly as the reference routes to its Pallas kernels: a cell
takes the CUDA step kernel of ``ops/fused_rnn.py`` when it is standard (no
peephole, sigmoid gates, tanh candidate), has a bias, ``h_dim % 128 ==
0``, the ``use_fused_rnn`` option is on and its input lies on the card;
otherwise it runs the plain step on the same device.  The kernel route's
gradient recomputes through the plain step.

As in the reference, the input of ``lstmemory`` / ``grumemory`` is the
gate projection (4h / 3h wide) made by an upstream fc.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch import activation as act_mod
from paddle_tpu_torch.core import config as cfg
from paddle_tpu_torch.core.ir import ParamSpec
from paddle_tpu_torch.core.registry import LayerDef, register_layer
from paddle_tpu_torch.layers.sequence import SeqLayerDef
from paddle_tpu_torch.ops import fused_rnn


def _on_card(x) -> bool:
    """The device half of the kernel route (the reference asks whether
    its backend is the TPU)."""
    return x.is_cuda


def _kernel_route(x, h_dim: int, standard: bool) -> bool:
    return (standard and h_dim % 128 == 0
            and cfg.get_option("use_fused_rnn", True) and _on_card(x))


def _time_major(x, mask):
    """[B, T, ...] input and [B, T] mask (None: all real) as contiguous
    time-major [T, B, ...] and [T, B], so each step's slice is contiguous."""
    xs = x.transpose(0, 1).contiguous()
    if mask is None:
        return xs, torch.ones(xs.shape[:2], dtype=torch.float32,
                              device=x.device)
    return xs, mask.transpose(0, 1).contiguous()


def _scan_time_major(step, carry, x, mask, reverse=False):
    """Loop ``step(carry, x_t, m_t) -> (carry, out_t)`` over the T axis of
    ``x`` [B, T, ...]; returns the outputs stacked as [B, T, ...]."""
    xs, ms = _time_major(x, mask)
    t_len = xs.shape[0]
    ys = [None] * t_len
    for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
        carry, ys[t] = step(carry, xs[t], ms[t])
    return torch.stack(ys, 1)


def _masked(new, old, m_t):
    """keep old state where the step is padding."""
    m = m_t.reshape((-1,) + (1,) * (new.ndim - 1))
    return new * m + old * (1.0 - m)


@register_layer
class RecurrentLayer(SeqLayerDef):
    """simple full-matrix recurrence: h_t = act(x_t + h_{t-1} @ W + b)
    (input pre-projected as in the reference)."""

    kind = "recurrent"
    out_is_seq = True

    def infer_shape(self, attrs, in_shapes):
        return in_shapes[0]

    def param_specs(self, attrs, in_shapes):
        d = in_shapes[0][-1]
        specs = [ParamSpec("w", (d, d), "xavier")]
        if attrs.get("bias", True):
            specs.append(ParamSpec("b", (d,), "zeros"))
        return specs

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        x, mask = inputs[0], masks[0]
        act = attrs.get("act", "tanh")
        w = params["w"]
        b = params.get("b", 0.0)
        h0 = torch.zeros((x.shape[0], x.shape[-1]), device=x.device)

        def step(h, x_t, m_t):
            h_new = _masked(act_mod.apply(act, x_t + h @ w + b), h, m_t)
            return h_new, h_new

        return _scan_time_major(step, h0, x, mask,
                                reverse=attrs.get("reverse", False))


@register_layer
class LstmemoryLayer(SeqLayerDef):
    """LSTM over a pre-projected gate input of width 4h: gates [input,
    forget, cell (candidate), output]; peephole ("check") diagonal weights
    on i/f/o unless ``peephole=False``."""

    kind = "lstmemory"
    out_is_seq = True

    def infer_shape(self, attrs, in_shapes):
        return (in_shapes[0][0], in_shapes[0][-1] // 4)

    def param_specs(self, attrs, in_shapes):
        h = in_shapes[0][-1] // 4
        specs = [ParamSpec("w", (h, 4 * h), "xavier")]   # recurrent weights
        if attrs.get("bias", True):
            specs.append(ParamSpec("b", (4 * h,), "zeros"))
        if attrs.get("peephole", True):
            specs += [ParamSpec("w_ci", (h,), "zeros"),
                      ParamSpec("w_cf", (h,), "zeros"),
                      ParamSpec("w_co", (h,), "zeros")]
        return specs

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        x, mask = inputs[0], masks[0]
        h_dim = x.shape[-1] // 4
        gate_act = attrs.get("gate_act", "sigmoid")
        cell_act = attrs.get("act", "tanh")   # candidate + output nonlinearity
        w = params["w"]
        b = params.get("b", 0.0)
        peep = "w_ci" in params
        h0 = torch.zeros((x.shape[0], h_dim), device=x.device)
        reverse = attrs.get("reverse", False)

        if _kernel_route(x, h_dim, not peep and gate_act == "sigmoid"
                         and cell_act == "tanh" and "b" in params):
            def step_fused(carry, x_t, m_t):
                h_new, c_new = fused_rnn.lstm_step(
                    x_t, *carry, w, params["b"], m_t.reshape(-1, 1))
                return (h_new, c_new), h_new

            return _scan_time_major(step_fused, (h0, h0), x, mask,
                                    reverse=reverse)

        def step(carry, x_t, m_t):
            h, c = carry
            gi, gf, gc, go = (x_t + h @ w + b).chunk(4, dim=-1)
            if peep:
                gi = gi + c * params["w_ci"]
                gf = gf + c * params["w_cf"]
            i = act_mod.apply(gate_act, gi)
            f = act_mod.apply(gate_act, gf)
            c_new = f * c + i * act_mod.apply(cell_act, gc)
            if peep:
                go = go + c_new * params["w_co"]
            o = act_mod.apply(gate_act, go)
            h_new = _masked(o * act_mod.apply(cell_act, c_new), h, m_t)
            return (h_new, _masked(c_new, c, m_t)), h_new

        return _scan_time_major(step, (h0, h0), x, mask, reverse=reverse)


def _gru_params(h):
    return [ParamSpec("w_g", (h, 2 * h), "xavier"),
            ParamSpec("w_c", (h, h), "xavier")]


@register_layer
class GrumemoryLayer(SeqLayerDef):
    """GRU over a pre-projected gate input of width 3h: the first 2h
    columns are the update and reset gates, the last h the candidate,
    whose recurrent term is (r * h_{t-1}) @ W_c."""

    kind = "grumemory"
    out_is_seq = True

    def infer_shape(self, attrs, in_shapes):
        return (in_shapes[0][0], in_shapes[0][-1] // 3)

    def param_specs(self, attrs, in_shapes):
        h = in_shapes[0][-1] // 3
        specs = _gru_params(h)
        if attrs.get("bias", True):
            specs.append(ParamSpec("b", (3 * h,), "zeros"))
        return specs

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        x, mask = inputs[0], masks[0]
        h_dim = x.shape[-1] // 3
        gate_act = attrs.get("gate_act", "sigmoid")
        cand_act = attrs.get("act", "tanh")
        b = params.get("b")
        h0 = torch.zeros((x.shape[0], h_dim), device=x.device)
        fused = _kernel_route(x, h_dim, gate_act == "sigmoid"
                              and cand_act == "tanh" and b is not None)

        def step(h, x_t, m_t):
            if fused:
                h_new = fused_rnn.gru_step(x_t, h, params["w_g"],
                                           params["w_c"], b,
                                           m_t.reshape(-1, 1))
            else:
                h_new = _gru_cell_step(h, x_t, m_t, h_dim, gate_act,
                                       cand_act, params["w_g"],
                                       params["w_c"], b)
            return h_new, h_new

        return _scan_time_major(step, h0, x, mask,
                                reverse=attrs.get("reverse", False))


def _gru_gates(h, x_t, h_dim, gate_act, cand_act, w_g, w_c, b):
    """One unmasked GRU update (the reference GruLayer gating)."""
    bz = b[:2 * h_dim] if b is not None else 0.0
    bc = b[2 * h_dim:] if b is not None else 0.0
    zr = act_mod.apply(gate_act, x_t[:, :2 * h_dim] + h @ w_g + bz)
    z, r = zr[:, :h_dim], zr[:, h_dim:]
    cand = act_mod.apply(cand_act, x_t[:, 2 * h_dim:] + (r * h) @ w_c + bc)
    return (1.0 - z) * h + z * cand


def _gru_cell_step(h, x_t, m_t, h_dim, gate_act, cand_act, w_g, w_c, b):
    """one masked GRU update - shared by the single-direction and fused
    bidirectional layers."""
    return _masked(_gru_gates(h, x_t, h_dim, gate_act, cand_act, w_g, w_c,
                              b), h, m_t)


@register_layer
class GruStepLayer(LayerDef):
    """One GRU step inside a recurrent_group: inputs = [gate input x_t of
    width 3h, previous state h of width h] -> new state h (the math of
    GrumemoryLayer; never the kernel, as in the reference)."""

    kind = "gru_step"

    def infer_shape(self, attrs, in_shapes):
        return (in_shapes[0][-1] // 3,)

    def param_specs(self, attrs, in_shapes):
        h = in_shapes[0][-1] // 3
        specs = _gru_params(h)
        if attrs.get("bias", True):
            specs.append(ParamSpec("b", (3 * h,), "zeros"))
        return specs

    def apply(self, attrs, params, inputs, ctx):
        x_t, h = inputs[0], inputs[1]
        return _gru_gates(h, x_t, x_t.shape[-1] // 3,
                          attrs.get("gate_act", "sigmoid"),
                          attrs.get("act", "tanh"), params["w_g"],
                          params["w_c"], params.get("b"))


@register_layer
class LstmStepLayer(LayerDef):
    """One LSTM step: inputs = [gate input x_t of width 4h, previous
    combined state [h | c] of width 2h] -> new combined state [h | c] (the
    JAX package's combined-state convention)."""

    kind = "lstm_step"

    def infer_shape(self, attrs, in_shapes):
        return (in_shapes[0][-1] // 2,)   # 4h input -> 2h combined state

    def param_specs(self, attrs, in_shapes):
        h = in_shapes[0][-1] // 4
        specs = [ParamSpec("w", (h, 4 * h), "xavier")]
        if attrs.get("bias", True):
            specs.append(ParamSpec("b", (4 * h,), "zeros"))
        return specs

    def apply(self, attrs, params, inputs, ctx):
        x_t, hc = inputs[0], inputs[1]
        h_dim = x_t.shape[-1] // 4
        gate_act = attrs.get("gate_act", "sigmoid")
        cell_act = attrs.get("act", "tanh")
        h, c = hc[:, :h_dim], hc[:, h_dim:]
        g = x_t + h @ params["w"] + params.get("b", 0.0)
        gi, gf, gc, go = g.chunk(4, dim=-1)
        i = act_mod.apply(gate_act, gi)
        f = act_mod.apply(gate_act, gf)
        c_new = f * c + i * act_mod.apply(cell_act, gc)
        o = act_mod.apply(gate_act, go)
        state_act = attrs.get("state_act") or cell_act
        h_new = o * act_mod.apply(state_act, c_new)
        return torch.cat([h_new, c_new], dim=-1)


@register_layer
class BiGruMemoryLayer(SeqLayerDef):
    """Fused bidirectional GRU: step t advances the forward state on
    x_fwd[t] and the backward state on x_bwd[T-1-t] in one loop.

    The backward direction walks reversed time with the reversed mask, so
    its pad steps come first and leave h at 0; its outputs are re-aligned
    in time.  inputs: [fwd 3h gate projection, bwd 3h gate projection];
    output [B, T, 2h] = concat(fwd states, time-aligned bwd states).  On
    the kernel route each direction's step is one launch, two a
    timestep."""

    kind = "bigru"
    out_is_seq = True

    def infer_shape(self, attrs, in_shapes):
        return (in_shapes[0][0], 2 * (in_shapes[0][-1] // 3))

    def param_specs(self, attrs, in_shapes):
        h = in_shapes[0][-1] // 3
        specs = []
        for d in ("fw", "bw"):
            specs += [ParamSpec(f"w_g_{d}", (h, 2 * h), "xavier"),
                      ParamSpec(f"w_c_{d}", (h, h), "xavier")]
            if attrs.get("bias", True):
                specs.append(ParamSpec(f"b_{d}", (3 * h,), "zeros"))
        return specs

    def apply_seq(self, attrs, params, inputs, masks, ctx):
        xf, xb = inputs[0], inputs[1]
        h_dim = xf.shape[-1] // 3
        gate_act = attrs.get("gate_act", "sigmoid")
        cand_act = attrs.get("act", "tanh")
        fused = _kernel_route(xf, h_dim, gate_act == "sigmoid"
                              and cand_act == "tanh"
                              and attrs.get("bias", True))

        def cell(h, x_t, m_t, d):
            if fused:
                return fused_rnn.gru_step(
                    x_t, h, params[f"w_g_{d}"], params[f"w_c_{d}"],
                    params[f"b_{d}"], m_t.reshape(-1, 1))
            return _gru_cell_step(h, x_t, m_t, h_dim, gate_act, cand_act,
                                  params[f"w_g_{d}"], params[f"w_c_{d}"],
                                  params.get(f"b_{d}"))

        xf_t, m_t = _time_major(xf, masks[0])
        xb_t = xb.transpose(0, 1).contiguous().flip(0)   # reversed time
        mr_t = m_t.flip(0)
        hf = hb = torch.zeros((xf.shape[0], h_dim), device=xf.device)
        ys_f, ys_b = [], []
        for t in range(xf_t.shape[0]):
            hf = cell(hf, xf_t[t], m_t[t], "fw")
            hb = cell(hb, xb_t[t], mr_t[t], "bw")
            ys_f.append(hf)
            ys_b.append(hb)
        return torch.cat([torch.stack(ys_f, 1), torch.stack(ys_b[::-1], 1)],
                         dim=-1)
