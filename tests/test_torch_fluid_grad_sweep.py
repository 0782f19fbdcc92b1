"""Gradient sweep of the port's Fluid ops, in the port alone and in float64
on the CPU.

Each case is a one-op program: its inputs are float64 variables (int64
for index slots), its loss the sum over the op's float outputs of
sum(out * cos(arange)), built from ported ops, and ``append_backward``
adds the grad ops, which the executor runs by autograd
(``executor._run_grad_op``).  For every input the IR gives a gradient, a
central difference of the loss along one seeded random direction d,
(L(x + eps d) - L(x - eps d)) / 2 eps, must equal <x@GRAD, d> within
1e-6 relative (float64 differences are good to ~1e-9 at eps = 1e-5).

``test_every_ported_op_is_swept`` holds the catalog: every op in
``ops.OPS`` is swept or has no float input that can take a gradient.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import ops as fops
from paddle_tpu_torch.fluid.framework import Program, program_guard

EPS = 1e-5
TOL = 1e-6


def _r(rng, *shape, lo=None):
    x = rng.randn(*shape)
    if lo is not None:                   # away from a kink or a pole
        x = np.sign(x) * (np.abs(x) + lo)
    return x


def _pos(rng, *shape):
    return rng.rand(*shape) + 0.5


def _ids(rng, hi, *shape):
    return rng.randint(0, hi, shape).astype(np.int64)


UNARY = ["sigmoid", "logsigmoid", "tanh", "square", "exp", "softplus",
         "softsign", "softmax", "mean", "assign"]
UNARY_AWAY = ["relu", "abs", "reciprocal", "leaky_relu", "elu", "swish",
              "sign"]
UNARY_POS = ["sqrt", "log"]
# piecewise constant away from the integers: the gradient is 0
UNARY_STEP = ["floor", "ceil", "round"]
ELEMENTWISE = ["elementwise_add", "elementwise_sub", "elementwise_mul",
               "elementwise_max", "elementwise_min"]


def _cases():
    """name -> (ins {slot: [arrays]}, attrs, output slots {slot: count})."""
    rng = np.random.RandomState(0)
    c = {}
    for n in UNARY:
        c[n] = ({"X": [_r(rng, 3, 4)]}, {}, {"Out": 1})
    for n in UNARY_AWAY:
        c[n] = ({"X": [_r(rng, 3, 4, lo=0.2)]}, {}, {"Out": 1})
    for n in UNARY_POS:
        c[n] = ({"X": [_pos(rng, 3, 4)]}, {}, {"Out": 1})
    for n in UNARY_STEP:
        c[n] = ({"X": [np.floor(_r(rng, 3, 4) * 3) + 0.3]}, {}, {"Out": 1})
    for n in ELEMENTWISE:
        c[n] = ({"X": [_r(rng, 2, 3, 4)], "Y": [_r(rng, 3)]}, {"axis": 1},
                {"Out": 1})
    c["elementwise_div"] = ({"X": [_r(rng, 2, 3)],
                             "Y": [_r(rng, 2, 3, lo=0.5)]}, {}, {"Out": 1})
    c["elementwise_pow"] = ({"X": [_pos(rng, 2, 3)], "Y": [_r(rng, 2, 3)]},
                            {}, {"Out": 1})
    c["brelu"] = ({"X": [_r(rng, 3, 4) + 2.0]}, {"t_min": 0.5,
                                                 "t_max": 24.0}, {"Out": 1})
    c["soft_relu"] = ({"X": [_r(rng, 3, 4)]}, {"threshold": 40.0},
                      {"Out": 1})
    c["relu6"] = ({"X": [_pos(rng, 3, 4) * 3]}, {}, {"Out": 1})
    c["pow"] = ({"X": [_pos(rng, 3, 4)]}, {"factor": 2.5}, {"Out": 1})
    c["stanh"] = ({"X": [_r(rng, 3, 4)]}, {}, {"Out": 1})
    c["hard_sigmoid"] = ({"X": [_r(rng, 3, 4) * 0.5]}, {}, {"Out": 1})
    c["scale"] = ({"X": [_r(rng, 3, 4)]}, {"scale": 2.0, "bias": 0.5},
                  {"Out": 1})
    c["clip"] = ({"X": [_r(rng, 3, 4) * 0.4]}, {"min": -0.9, "max": 0.9},
                 {"Out": 1})
    c["clip_by_norm"] = ({"X": [_r(rng, 3, 4)]}, {"max_norm": 1.0},
                         {"Out": 1})
    c["cumsum"] = ({"X": [_r(rng, 3, 4)]}, {"axis": 1}, {"Out": 1})
    c["mul"] = ({"X": [_r(rng, 2, 3, 4)], "Y": [_r(rng, 4, 5)]},
                {"x_num_col_dims": 2}, {"Out": 1})
    c["matmul"] = ({"X": [_r(rng, 2, 3)], "Y": [_r(rng, 4, 3)]},
                   {"transpose_Y": True, "alpha": 0.5}, {"Out": 1})
    for n in ("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
              "reduce_prod"):
        c[n] = ({"X": [_r(rng, 2, 3, 4, lo=0.1)]}, {"dim": [1]},
                {"Out": 1})
    c["reshape"] = ({"X": [_r(rng, 2, 6)]}, {"shape": [0, 3, -1]},
                    {"Out": 1})
    c["transpose"] = ({"X": [_r(rng, 2, 3, 4)]}, {"axis": [2, 0, 1]},
                      {"Out": 1})
    c["concat"] = ({"X": [_r(rng, 2, 3), _r(rng, 2, 2)]}, {"axis": 1},
                   {"Out": 1})
    c["split"] = ({"X": [_r(rng, 2, 6)]}, {"num": 3, "axis": 1},
                  {"Out": 3})
    c["sum"] = ({"X": [_r(rng, 2, 3), _r(rng, 2, 3), _r(rng, 2, 3)]}, {},
                {"Out": 1})
    c["expand"] = ({"X": [_r(rng, 2, 3)]}, {"expand_times": [2, 1]},
                   {"Out": 1})
    c["crop"] = ({"X": [_r(rng, 3, 4)]}, {"offsets": [1, 0],
                                          "shape": [2, -1]}, {"Out": 1})
    c["lookup_table"] = ({"W": [_r(rng, 5, 3)], "Ids": [_ids(rng, 5, 2, 4, 1)]},
                         {}, {"Out": 1})
    c["softmax_with_cross_entropy"] = (
        {"Logits": [_r(rng, 3, 4)], "Label": [_ids(rng, 4, 3, 1)]}, {},
        {"Softmax": 1, "Loss": 1})
    c["cross_entropy"] = ({"X": [_pos(rng, 3, 4)],
                           "Label": [_ids(rng, 4, 3, 1)]}, {}, {"Out": 1})
    c["square_error_cost"] = ({"X": [_r(rng, 3, 2)], "Y": [_r(rng, 3, 2)]},
                              {}, {"Out": 1})
    c["squared_l2_norm"] = ({"X": [_r(rng, 3, 2)]}, {}, {"Out": 1})
    c["conv2d"] = ({"Input": [_r(rng, 2, 2, 5, 5)],
                    "Filter": [_r(rng, 3, 2, 3, 3)]},
                   {"strides": [1, 1], "paddings": [1, 1]}, {"Output": 1})
    c["pool2d"] = ({"X": [_r(rng, 2, 2, 4, 4)]},
                   {"ksize": [2, 2], "strides": [2, 2],
                    "pooling_type": "max"}, {"Out": 1})
    c["batch_norm"] = ({"X": [_r(rng, 4, 3, 2, 2)], "Scale": [_pos(rng, 3)],
                        "Bias": [_r(rng, 3)], "Mean": [np.zeros(3)],
                        "Variance": [np.ones(3)]}, {},
                       {"Y": 1, "MeanOut": 1, "VarianceOut": 1,
                        "SavedMean": 1, "SavedVariance": 1})
    c["dropout"] = ({"X": [_r(rng, 4, 5)]}, {"dropout_prob": 0.4},
                    {"Out": 1, "Mask": 1})
    c["lstm"] = ({"Input": [_r(rng, 2, 3, 8)], "Weight": [_r(rng, 2, 8)],
                  "Bias": [_r(rng, 8)],
                  "Mask": [np.array([[1., 1., 1.], [1., 1., 0.]])]},
                 {"is_reverse": True}, {"Hidden": 1, "Cell": 1})
    c["gru"] = ({"Input": [_r(rng, 2, 3, 6)], "Weight": [_r(rng, 2, 6)],
                 "Bias": [_r(rng, 6)]}, {}, {"Hidden": 1})
    c["linear_chain_crf"] = ({"Emission": [_r(rng, 2, 4, 3)],
                              "Transition": [_r(rng, 5, 3)],
                              "Label": [_ids(rng, 3, 2, 4)],
                              "Length": [np.array([4, 3], np.int64)]},
                             {}, {"LogLikelihood": 1})
    c["nce"] = ({"Input": [_r(rng, 4, 5)], "Label": [_ids(rng, 7, 4, 1)],
                 "Weight": [_r(rng, 7, 5)], "Bias": [_r(rng, 7)]},
                {"num_neg_samples": 3}, {"Cost": 1})
    return c


CASES = _cases()
# no float input that takes a gradient: integer or random outputs, the
# fills, and the optimizer updates (applied after the backward)
NONDIFF = {"cast", "increment", "top_k", "fill_zeros_like",
           "fill_constant", "fill_constant_batch_size_like", "assign_value",
           "uniform_random", "gaussian_random", "accuracy", "crf_decoding",
           "beam_search", "beam_search_decode", "sgd", "momentum",
           "adagrad", "adam", "adamax", "adadelta", "decayed_adagrad",
           "rmsprop", "ftrl"}
# float inputs that stay out of the backward, as a data layer's would
NO_GRAD_SLOTS = {"Mask", "Mean", "Variance"}


def _shape_outputs(name, ins, attrs):
    """The op's output shapes (one direct call), so the weights fit."""
    ctx = fluid.executor.OpRunCtx(True, torch.device("cpu"), 0, 0, 1)
    t = {s: [torch.as_tensor(a) for a in arrs] for s, arrs in ins.items()}
    return fops.get_op(name).fn(ctx, attrs, t)


@pytest.fixture
def fixed_negatives(monkeypatch):
    monkeypatch.setattr(fops, "nce_negatives", lambda ctx, n, c:
                        torch.tensor([1, 4, 4], device=ctx.device))


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_grad(name, fixed_negatives):
    ins, attrs, outs = CASES[name]
    # each output's loss weights are an assign of its own shape
    shapes = {s: [tuple(v.shape) for v in vs]
              for s, vs in _shape_outputs(name, ins, attrs).items()}
    main, startup = Program(), Program()
    with program_guard(main, startup):
        blk = main.global_block()
        in_names = {}
        for slot, arrs in ins.items():
            in_names[slot] = [blk.create_var(
                name=f"{slot}_{j}", shape=a.shape, dtype=str(a.dtype),
                stop_gradient=(slot in NO_GRAD_SLOTS
                               or a.dtype != np.float64)).name
                for j, a in enumerate(arrs)]
        out_names = {s: [blk.create_var(name=f"out_{s}_{j}",
                                        shape=shapes[s][j],
                                        dtype="float64").name
                         for j in range(n)] for s, n in outs.items()}
        blk.append_op(name, inputs=in_names, outputs=out_names,
                      attrs=dict(attrs))
        terms = []
        for s, names in out_names.items():
            for j, n in enumerate(names):
                shp = shapes[s][j]
                w = fluid.layers.assign(np.cos(
                    np.arange(int(np.prod(shp)), dtype=np.float64)
                ).reshape(shp))
                terms.append(fluid.layers.reduce_sum(
                    fluid.layers.elementwise_mul(blk.var(n), w)))
        loss = fluid.layers.sums(terms)
        fluid.backward.append_backward(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    feed = {n: a for slot, arrs in ins.items()
            for n, a in zip(in_names[slot], arrs)}
    diff = [n for slot, names in in_names.items() for n in names
            if not blk.var(n).stop_gradient]
    assert diff, name

    def run(f, fetch):
        exe._step = 0          # one random stream for every evaluation
        return exe.run(main, feed=f, fetch_list=fetch,
                       scope=fluid.Scope())

    got = run(feed, [loss] + [n + "@GRAD" for n in diff])
    assert got[0].dtype == np.float64
    rng = np.random.RandomState(1)
    for n, g in zip(diff, got[1:]):
        d = rng.randn(*feed[n].shape)
        lp = run({**feed, n: feed[n] + EPS * d}, [loss])[0]
        lm = run({**feed, n: feed[n] - EPS * d}, [loss])[0]
        numeric = float(np.sum(lp - lm)) / (2 * EPS)
        analytic = float(np.sum(g * d))
        assert abs(numeric - analytic) <= TOL * (1 + abs(numeric)), (
            f"{name}: {n}: IR gradient {analytic!r} vs central "
            f"difference {numeric!r}")


def test_every_ported_op_is_swept():
    missing = sorted(set(fops.OPS) - set(CASES) - NONDIFF)
    assert not missing, f"ported ops not in the grad sweep: {missing}"
    assert not (set(CASES) & NONDIFF)
