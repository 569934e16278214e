"""The heads' `matmul_precision` switch (the counterpart of
`jax_default_matmul_precision`): "bfloat16" is the f32 product of
bf16-rounded operands, forward and backward; "float32" is the plain f32
head. Exact equality (tolerance 0) against the same arithmetic written out,
and against the JAX head at float32 to 1e-6."""
import numpy as np
import pytest
import torch

from lmrl_gym_torch.models.heads import LinearHead, LinearHeadConfig, MLPHead, MLPHeadConfig
from lmrl_gym_torch.scripts import maze_ilql_gate, wordle_ilql_gate


def _r(t):
    return t.to(torch.bfloat16).float()


def _inputs(seed=0, B=3, T=5, D=16):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal((B, T, D)), dtype=torch.float32, requires_grad=True)


def _mlp(precision, D=16, H=32, V=24):
    head = MLPHead(MLPHeadConfig(D, H, V, layer2_bias_init=-1.0, matmul_precision=precision), device="cpu", seed=3)
    with torch.no_grad():
        head.dense2.weight.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(4))
    return head


def test_bf16_mlp_head_forward_and_backward_match_rounded_operands():
    x = _inputs()
    head = _mlp("bfloat16")
    y = head(x)
    dy = torch.tensor(np.random.default_rng(1).standard_normal(y.shape), dtype=torch.float32)
    y.backward(dy)

    # the same arithmetic written out, with explicit rounding of every operand
    w1, b1 = head.dense1.weight.detach(), head.dense1.bias.detach()
    w2, b2 = head.dense2.weight.detach(), head.dense2.bias.detach()
    xd = x.detach()
    h_pre = _r(xd) @ _r(w1).t() + b1
    h = torch.nn.functional.gelu(h_pre, approximate="tanh")
    y_ref = _r(h) @ _r(w2).t() + b2
    assert torch.equal(y.detach(), y_ref)

    dh = _r(dy) @ _r(w2)
    dw2 = _r(dy.reshape(-1, dy.shape[-1])).t() @ _r(h.reshape(-1, h.shape[-1]))
    hp = h_pre.clone().requires_grad_(True)
    (dh_pre,) = torch.autograd.grad(torch.nn.functional.gelu(hp, approximate="tanh"), hp, dh)
    dx = _r(dh_pre) @ _r(w1)
    dw1 = _r(dh_pre.reshape(-1, dh_pre.shape[-1])).t() @ _r(xd.reshape(-1, xd.shape[-1]))
    assert torch.equal(head.dense2.weight.grad, dw2)
    assert torch.equal(head.dense2.bias.grad, dy.sum(dim=(0, 1)))
    assert torch.equal(head.dense1.weight.grad, dw1)
    assert torch.equal(head.dense1.bias.grad, dh_pre.sum(dim=(0, 1)))
    assert torch.equal(x.grad, dx)


def test_bf16_differs_from_f32_and_f32_is_the_plain_head():
    x = _inputs(seed=2)
    f32, bf16 = _mlp("float32"), _mlp("bfloat16")
    y32, y16 = f32(x), bf16(x)
    assert not torch.equal(y32, y16)
    assert torch.allclose(y32, y16, atol=5e-2)
    # float32 is exactly the head as it was: dense1 → gelu → dense2 in f32
    w1, b1, w2, b2 = (p.detach() for p in (f32.dense1.weight, f32.dense1.bias, f32.dense2.weight, f32.dense2.bias))
    ref = torch.nn.functional.linear(torch.nn.functional.gelu(torch.nn.functional.linear(x, w1, b1),
                                                              approximate="tanh"), w2, b2)
    assert torch.equal(y32, ref)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_linear_head_precision(precision):
    x = _inputs(seed=5)
    head = LinearHead(LinearHeadConfig(16, 7, bias_init=0.5, matmul_precision=precision), device="cpu", seed=1)
    y = head(x)
    dy = torch.tensor(np.random.default_rng(6).standard_normal(y.shape), dtype=torch.float32)
    y.backward(dy)
    w, b, xd = head.dense.weight.detach(), head.dense.bias.detach(), x.detach()
    rnd = _r if precision == "bfloat16" else (lambda t: t)
    assert torch.equal(y.detach(), torch.nn.functional.linear(rnd(xd), rnd(w), b))
    assert torch.equal(x.grad, rnd(dy) @ rnd(w))
    assert torch.equal(head.dense.weight.grad, rnd(dy.reshape(-1, 7)).t() @ rnd(xd.reshape(-1, 16)))


def test_unknown_precision_raises():
    head = MLPHead(MLPHeadConfig(8, 8, 2, matmul_precision="tf32"), device="cpu")
    with pytest.raises(ValueError, match="matmul_precision"):
        head(torch.zeros(1, 8))


def test_float32_heads_match_jax_heads():
    import jax.numpy as jnp

    from lmrl_gym_tpu.models import heads as jheads
    from lmrl_gym_torch.models.convert import head_params_from_jax

    kw = dict(input_dim=16, hidden_dim=32, output_dim=24, layer2_bias_init=-1.0)
    jhead = jheads.MLPHead(jheads.MLPHeadConfig(**kw))
    x = np.random.default_rng(7).standard_normal((2, 4, 16)).astype(np.float32)
    import jax

    params = jhead.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    head = MLPHead(MLPHeadConfig(**kw), device="cpu")
    head.load_state_dict(head_params_from_jax(params))
    np.testing.assert_allclose(head(torch.tensor(x)).detach().numpy(),
                               np.asarray(jhead.apply({"params": params}, jnp.asarray(x))), atol=1e-6)


def test_gate_flag_reaches_every_head():
    args = wordle_ilql_gate.parse_args(["--device", "cpu", "--hidden", "32", "--layers", "1", "--heads", "2",
                                        "--eval-batch", "4", "--head-matmul-precision", "bfloat16"])
    assert wordle_ilql_gate.parse_args([]).head_matmul_precision == "float32"
    g = wordle_ilql_gate.Gate(args, dtype="float32")
    from lmrl_gym_torch.models.transformer import init_params

    state, _ = g.init_ilql(init_params(g.config, seed=0, device="cpu"))
    for head in (state.q1_head.params, state.q2_head.params, state.v_head.params,
                 state.q1_target_params, state.q2_target_params):
        assert head.config.matmul_precision == "bfloat16"


@pytest.mark.parametrize("algo", ["ilql", "cql", "mc"])
def test_maze_gate_heads_start_from_the_initial_draw(algo):
    """Every head of the maze gate's value state (online and target) is an
    f32 copy of its initial head, not the initial module itself."""
    args = maze_ilql_gate.parse_args(["--device", "cpu", "--hidden", "32", "--layers", "1", "--heads", "2",
                                      "--algo", algo])
    g = maze_ilql_gate.Gate(args, dtype="float32")
    q1, q2, v = g.initial_weights().heads
    state, _ = g.init_value_state(g.initial_weights().trunk, n_examples=4)
    want = {"ilql": [q1, q2, v, q1, q2], "cql": [q1, q2, q1, q2], "mc": [q1]}[algo]
    heads = [state.q1_head.params, state.q2_head.params] if algo != "mc" else [state.q_head.params]
    heads += [state.v_head.params] if algo == "ilql" else []
    heads += [state.q1_target_params, state.q2_target_params] if algo != "mc" else []
    assert len(heads) == len(want)
    for head, initial in zip(heads, want):
        assert head is not initial and head.config.matmul_precision == "float32"
        for k, t in initial.state_dict().items():
            assert torch.equal(head.state_dict()[k], t), k
        assert not head.dense2.weight.any()  # the zero-init second layer
