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
``ops.OPS`` is swept, or has no float input that can take a gradient, or
is a control-flow op differentiated by ``test_torch_fluid_control_flow.py``;
``test_sweep_accounts_for_the_jax_catalog`` holds it against the JAX
sweep's partition (``tests/test_fluid_op_grad_sweep.py``).
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
    c.update(_cases_rest(rng))
    return c


def _boxes(rng, n):
    """[n, 4] well-formed xyxy boxes, width and height >= 0.1."""
    lo = rng.uniform(0, 0.4, (n, 2))
    return np.concatenate([lo, lo + rng.uniform(0.1, 0.5, (n, 2))], 1)


def _cases_rest(rng):
    """the rest of the catalog: the JAX sweep's cases of the ops the
    port's Fluid gained with its control flow."""
    c = {}
    for n in ("minus", "squared_l2_distance"):
        c[n] = ({"X": [_r(rng, 2, 3)], "Y": [_r(rng, 2, 3)]}, {},
                {"Out": 1})
    c["l1_norm"] = ({"X": [_r(rng, 2, 3, lo=0.3)]}, {}, {"Out": 1})
    c["print"] = ({"X": [_r(rng, 2, 3)]}, {"message": "sweep"}, {"Out": 1})
    c["norm"] = ({"X": [_r(rng, 2, 4, lo=0.3)]}, {}, {"Out": 1})
    c["lrn"] = ({"X": [_r(rng, 2, 6, 4, 4)]}, {}, {"Out": 1})
    c["pad"] = ({"X": [_r(rng, 2, 3)]}, {"paddings": [0, 1, 1, 2]},
                {"Out": 1})
    c["gather"] = ({"X": [_r(rng, 5, 3)],
                    "Index": [np.array([0, 2, 4], np.int64)]}, {},
                   {"Out": 1})
    c["scatter"] = ({"X": [_r(rng, 5, 3)],
                     "Ids": [np.array([1, 3], np.int64)],
                     "Updates": [_r(rng, 2, 3)]}, {}, {"Out": 1})
    c["multiplex"] = ({"Ids": [_ids(rng, 2, 3, 1)],
                       "X": [_r(rng, 3, 4), _r(rng, 3, 4)]}, {}, {"Out": 1})
    c["where"] = ({"Cond": [np.array([[True, False, True],
                                      [False, True, False]])],
                   "X": [_r(rng, 2, 3)], "Y": [_r(rng, 2, 3)]}, {},
                  {"Out": 1})
    c["label_smooth"] = ({"X": [_r(rng, 3, 4)]}, {"epsilon": 0.2},
                         {"Out": 1})
    c["lod_reset"] = ({"X": [_r(rng, 2, 3)], "Y": [_ids(rng, 3, 2)]}, {},
                      {"Out": 1})
    c["bilinear_tensor_product"] = (
        {"X": [_r(rng, 2, 3)], "Y": [_r(rng, 2, 4)],
         "Weight": [_r(rng, 2, 3, 4)], "Bias": [_r(rng, 1, 2)]}, {},
        {"Out": 1})
    c["cos_sim"] = ({"X": [_r(rng, 2, 4, lo=0.3)],
                     "Y": [_r(rng, 2, 4, lo=0.3)]}, {}, {"Out": 1})
    c["conv_shift"] = ({"X": [_r(rng, 2, 6)], "Y": [_r(rng, 2, 3)]}, {},
                       {"Out": 1})
    c["prelu"] = ({"X": [_r(rng, 2, 4, lo=0.3)], "Alpha": [np.array([0.25])]},
                  {}, {"Out": 1})
    c["sigmoid_cross_entropy_with_logits"] = (
        {"X": [_r(rng, 2, 4)], "Label": [rng.uniform(0.1, 0.9, (2, 4))]}, {},
        {"Out": 1})
    c["log_loss"] = ({"Predicted": [rng.uniform(0.2, 0.8, (3, 1))],
                      "Labels": [rng.randint(0, 2, (3, 1)) * 1.0]}, {},
                     {"Loss": 1})
    c["hinge_loss"] = ({"Logits": [_r(rng, 3, 1) * 0.3],
                        "Labels": [np.array([[1.0], [0.0], [1.0]])]}, {},
                       {"Loss": 1})
    c["huber_loss"] = ({"X": [np.array([[0.0], [1.0], [2.0]])],
                        "Y": [np.array([[0.3], [-0.7], [2.2]])]},
                       {"delta": 1.0}, {"Out": 1})
    c["modified_huber_loss"] = ({"X": [np.array([[0.5], [-0.6], [2.0]])],
                                 "Y": [np.array([[1.0], [1.0], [0.0]])]},
                                {}, {"Out": 1, "IntermediateVal": 1})
    c["smooth_l1"] = ({"X": [_r(rng, 2, 4) * 0.2], "Y": [_r(rng, 2, 4) * 0.2]},
                      {}, {"Out": 1})
    c["rank_loss"] = ({"Label": [np.array([[1.0], [0.0]])],
                       "Left": [_r(rng, 2, 1)], "Right": [_r(rng, 2, 1)]},
                      {}, {"Out": 1})
    c["margin_rank_loss"] = ({"Label": [np.array([[1.0], [-1.0]])],
                              "X1": [np.array([[1.2], [0.1]])],
                              "X2": [np.array([[0.2], [1.3]])]},
                             {"margin": 0.3}, {"Out": 1})
    c["warpctc"] = ({"Logits": [_r(rng, 2, 6, 4)],
                     "Label": [rng.randint(1, 4, (2, 2)).astype(np.int64)],
                     "LogitsLength": [np.array([6, 5], np.int64)],
                     "LabelLength": [np.array([2, 1], np.int64)]}, {},
                    {"Loss": 1})
    c["conv2d_transpose"] = ({"Input": [_r(rng, 2, 3, 4, 4)],
                              "Filter": [_r(rng, 3, 2, 2, 2) * 0.3]},
                             {"strides": [2, 2], "paddings": [0, 0]},
                             {"Output": 1})
    c["max_pool2d_with_index"] = (
        {"X": [rng.permutation(2 * 3 * 16).reshape(2, 3, 4, 4) * 0.1]},
        {"ksize": [2, 2]}, {"Out": 1})
    c["spp"] = ({"X": [rng.permutation(2 * 2 * 16).reshape(2, 2, 4, 4)
                       * 1.0]}, {"pyramid_height": 2}, {"Out": 1})
    c["unpool"] = ({"X": [_r(rng, 2, 2, 2, 2)],
                    "Indices": [np.tile(np.array([0, 5, 10, 15], np.int64)
                                        .reshape(1, 1, 2, 2), (2, 2, 1, 1))]},
                   {"unpool_size": [4, 4]}, {"Out": 1})
    c["im2sequence"] = ({"X": [_r(rng, 2, 3, 4, 4)]},
                        {"kernels": [2, 2], "strides": [2, 2]}, {"Out": 1})
    c["layer_norm"] = ({"X": [_r(rng, 3, 4)], "Scale": [_pos(rng, 4)],
                        "Bias": [_r(rng, 4)]}, {},
                       {"Y": 1, "Mean": 1, "Variance": 1})
    c["lstm_unit"] = ({"X": [_r(rng, 2, 12)], "C_prev": [_r(rng, 2, 3)]},
                      {"forget_bias": 0.5}, {"C": 1, "H": 1})
    c["gru_unit"] = ({"Input": [_r(rng, 2, 9) * 0.3],
                      "HiddenPrev": [_r(rng, 2, 3) * 0.3],
                      "Weight": [_r(rng, 3, 9) * 0.3],
                      "Bias": [_r(rng, 1, 9) * 0.1]}, {},
                     {"Gate": 1, "ResetHiddenPrev": 1, "Hidden": 1})
    c["lstmp"] = ({"Input": [_r(rng, 2, 5, 12) * 0.3],
                   "Weight": [_r(rng, 2, 12) * 0.3],
                   "ProjWeight": [_r(rng, 3, 2) * 0.3],
                   "Bias": [_r(rng, 1, 12) * 0.1],
                   "C0": [_r(rng, 2, 3) * 0.3], "H0": [_r(rng, 2, 2) * 0.3],
                   "Mask": [np.array([[1.0] * 5, [1.0] * 3 + [0.0] * 2])]},
                  {}, {"Projection": 1, "Cell": 1})
    c["sequence_conv"] = ({"X": [_r(rng, 2, 5, 3)],
                           "Filter": [_r(rng, 9, 4) * 0.3]},
                          {"context_length": 3}, {"Out": 1})
    c["row_conv"] = ({"X": [_r(rng, 2, 5, 3)], "Filter": [_r(rng, 2, 3)]},
                     {}, {"Out": 1})
    c["sequence_concat"] = ({"X": [_r(rng, 2, 4, 3)], "Y": [_r(rng, 2, 3, 3)],
                             "XLen": [np.array([4, 2], np.int64)],
                             "YLen": [np.array([3, 1], np.int64)]}, {},
                            {"Out": 1})
    c["sequence_slice"] = ({"X": [_r(rng, 2, 5, 3)],
                            "Offset": [np.array([[1], [0]], np.int64)],
                            "Length": [np.array([[3], [2]], np.int64)]}, {},
                           {"Out": 1})
    c["sequence_reshape"] = ({"X": [_r(rng, 2, 4, 6)]}, {"new_dim": 3},
                             {"Out": 1})
    c["shrink_rnn_memory"] = ({"X": [_r(rng, 3, 4)],
                               "Lens": [np.array([3, 2, 1], np.int64)],
                               "I": [np.array([1], np.int64)]}, {},
                              {"Out": 1})
    c["lod_tensor_to_array"] = ({"X": [_r(rng, 2, 3, 4)]}, {}, {"Out": 1})
    c["array_to_lod_tensor"] = ({"X": [_r(rng, 3, 2, 4)]}, {}, {"Out": 1})
    c["box_coder"] = ({"PriorBox": [_boxes(rng, 4)],
                       "PriorBoxVar": [np.array([0.1, 0.1, 0.2, 0.2])],
                       "TargetBox": [_boxes(rng, 4)]}, {}, {"Out": 1})
    c["roi_pool"] = ({"X": [np.arange(72.0).reshape(1, 6, 6, 2) * 0.11
                            + 0.05],
                      "ROIs": [np.array([[0, 0.0, 0.0, 4.0, 4.0],
                                         [0, 1.0, 2.0, 5.0, 5.0]])]},
                     {"pooled_height": 2, "pooled_width": 2,
                      "spatial_scale": 1.0}, {"Out": 1})
    c["split_selected_rows"] = ({"Ids": [np.array([1, 7, 3, 9], np.int64)],
                                 "Values": [_r(rng, 4, 3)]},
                                {"height_sections": [5, 5]},
                                {"OutValues": 2})
    return c


CASES = _cases()
# no float input that takes a gradient: integer or random outputs, the
# fills, and the optimizer updates (applied after the backward)
NONDIFF = {"cast", "increment", "top_k", "fill_zeros_like",
           "fill_constant", "fill_constant_batch_size_like", "assign_value",
           "uniform_random", "gaussian_random", "accuracy", "crf_decoding",
           "beam_search", "beam_search_decode", "sgd", "momentum",
           "adagrad", "adam", "adamax", "adadelta", "decayed_adagrad",
           "rmsprop", "ftrl", "proximal_gd", "proximal_adagrad",
           "less_than", "less_equal", "greater_than", "greater_equal",
           "equal", "not_equal", "logical_and", "logical_or",
           "logical_xor", "logical_not", "sequence_mask", "is_empty",
           "one_hot", "sequence_erase", "ctc_align", "edit_distance",
           "iou_similarity", "prior_box", "bipartite_match",
           "target_assign", "mine_hard_examples", "multiclass_nms",
           "detection_map", "auc", "precision_recall", "chunk_eval",
           "positive_negative_pair", "lod_rank_table", "while"}
# differentiable, with a sub-block: differentiated (against the JAX
# package and finite differences) in test_torch_fluid_control_flow.py
DIFF_VIA_CONTROL_FLOW_TESTS = {"recurrent", "bounded_while",
                               "conditional_block", "array_read",
                               "array_write"}
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
    spec = fops.get_op(name)
    diff_slots = (spec.inputs if spec.differentiable is None
                  else spec.differentiable)
    main, startup = Program(), Program()
    with program_guard(main, startup):
        blk = main.global_block()
        in_names = {}
        for slot, arrs in ins.items():
            in_names[slot] = [blk.create_var(
                name=f"{slot}_{j}", shape=a.shape, dtype=str(a.dtype),
                stop_gradient=(slot in NO_GRAD_SLOTS or slot not in diff_slots
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
    missing = sorted(set(fops.OPS) - set(CASES) - NONDIFF
                     - DIFF_VIA_CONTROL_FLOW_TESTS)
    assert not missing, f"ported ops not in the grad sweep: {missing}"
    assert not (set(CASES) & NONDIFF)
    stale = sorted((set(CASES) | NONDIFF | DIFF_VIA_CONTROL_FLOW_TESTS)
                   - set(fops.OPS))
    assert not stale, f"the sweep names unregistered ops: {stale}"
    for name in DIFF_VIA_CONTROL_FLOW_TESTS:   # None: every input slot
        assert fops.get_op(name).differentiable != (), name


def test_sweep_accounts_for_the_jax_catalog():
    """Every op of the port's registry is swept here, or is in the JAX
    sweep's NONDIFF, or is differentiated by the control-flow tests; and
    every op the JAX sweep grad-checks is swept here or there."""
    import test_fluid_op_grad_sweep as jsweep

    swept = set(CASES) | DIFF_VIA_CONTROL_FLOW_TESTS
    missing = sorted(set(fops.OPS) - swept - jsweep.NONDIFF)
    assert not missing, f"ops neither swept nor nondiff: {missing}"
    assert not sorted(set(jsweep.CASES) - swept)
    assert set(fops.OPS) == (set(jsweep.CASES) | jsweep.NONDIFF
                             | jsweep.DIFF_VIA_CONTROL_FLOW_TESTS)
