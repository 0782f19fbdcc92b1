"""The ``networks`` helpers of item 11b (multi_head_attention,
dot_product_attention, lstmemory_unit / lstmemory_group, gru_unit /
gru_group / simple_gru2, sequence_conv_pool / text_conv_pool, inputs and
outputs) in the port against the JAX package on the CPU: each helper's
topology JSON is byte-equal, and its forward and every parameter and
input gradient agree from the same weights and seeded feeds, full and
with padded sequences, within 1e-5 absolute and relative
(``test_torch_layer_parity.assert_parity``); the models are those of
``tests/torch_networks_configs.py``."""

import pytest

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.core.ir import reset_name_counters as reset_jax_names
from paddle_tpu_torch.core.ir import reset_name_counters as reset_port_names
from test_torch_layer_parity import assert_parity, both
from torch_networks_configs import CONFIGS, feed


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_helper_matches_jax(name, padded):
    ttopo, jtopo, values = both(CONFIGS[name])
    assert_parity(ttopo, jtopo, values, feed(ttopo, padded))


@pytest.mark.parametrize("paddle", [pt, pj], ids=["port", "jax"])
def test_multi_head_attention_refuses_two_widths(paddle):
    L, dt = paddle.layer, paddle.data_type
    x = L.data("x", dt.dense_vector_sequence(8, max_len=4))
    with pytest.raises(ValueError, match="one projection width"):
        paddle.networks.multi_head_attention(x, x, x, head_num=2,
                                             key_proj_size=4)


def test_inputs_and_outputs_declarations():
    decls = []
    for paddle, reset in ((pt, reset_port_names), (pj, reset_jax_names)):
        reset()
        L, dt = paddle.layer, paddle.data_type
        a = L.data("a", dt.dense_vector(3))
        b = L.data("b", dt.dense_vector(3))
        cost = L.sum_cost(L.fc(a, size=2))
        names = paddle.networks.inputs([a, b])
        outs = paddle.networks.outputs(cost)
        assert outs == [cost]
        assert paddle.networks._DECLARED_OUTPUTS == [cost]
        decls.append((names, [o.name for o in outs]))
    assert decls[0] == decls[1] == (["a", "b"], [decls[0][1][0]])
