"""Gradients of the port's `flash_attention` against the JAX package's.

On the CPU the port's call goes through its autograd function
(`_FlashAttnFunction`) with the plain versions of K1 (forward) and K2/K3
(backward); the JAX side is `jax.grad` of `lmrl_gym_tpu.ops.flash_attention`
with `_FORCE_INTERPRET`, so its Pallas forward and backward kernels run in
interpret mode. Same numpy inputs, loss sum(out²) as tests/test_ops.py
uses. Tolerance: 1e-4 abs/rel, as tests/test_ops.py holds the Pallas
gradients to XLA's (f32, different summation orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lmrl_gym_tpu.ops.flash_attention as jfa
from lmrl_gym_torch.ops import flash_attention as tfa

NEG_BIG = -0.7 * float(np.finfo(np.float32).max)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)


@pytest.mark.parametrize(
    "B,H,Tq,S,Dh,padded",
    [
        (1, 1, 128, 128, 32, False),  # tests/test_ops.py::test_flash_gradients_match_xla
        (1, 2, 128, 128, 64, True),  # padding bias: the last 5 kv slots of batch 0 masked
        (2, 1, 200, 200, 32, True),  # non-multiple of the block
        (1, 1, 128, 256, 64, True),  # Tq < S: queries right-aligned
    ],
)
def test_flash_attention_grads_match_jax(interpret, B, H, Tq, S, Dh, padded):
    rng = np.random.default_rng(Tq + S + Dh)
    q = rng.standard_normal((B, H, Tq, Dh), np.float32)
    k = rng.standard_normal((B, H, S, Dh), np.float32)
    v = rng.standard_normal((B, H, S, Dh), np.float32)
    bias = np.zeros((B, S), np.float32)
    if padded:
        bias[0, S - 5:] = NEG_BIG
    assert jfa.supports_flash(q.shape, S)

    def jloss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, jnp.asarray(bias), causal=True, block_q=128, block_k=128) ** 2)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, torch.from_numpy(bias))
    assert out.grad_fn is not None and type(out.grad_fn).__name__.startswith("_FlashAttnFunction")
    tgrads = torch.autograd.grad((out**2).sum(), (tq, tk, tv))
    for name, a, b in zip(("dq", "dk", "dv"), tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)


def test_plain_backward_matches_jax_backward_pieces(interpret):
    """The plain backward from the same residuals (out, lse) as the JAX
    package's `_flash_backward`, and Δ computed outside the kernels."""
    B, H, T, Dh = 2, 2, 128, 32
    rng = np.random.default_rng(5)
    q, k, v, g = (rng.standard_normal((B, H, T, Dh), np.float32) for _ in range(4))
    bias = np.zeros((B, T), np.float32)
    bias[1, T - 9:] = NEG_BIG
    scale = 1.0 / Dh**0.5
    jargs = tuple(map(jnp.asarray, (q, k, v, bias)))
    jout, jlse = jfa._flash_forward(*jargs, True, scale, 128, 128)
    jdq, jdk, jdv, jdbias = jfa._flash_backward(*jargs, jout, jlse, jnp.asarray(g), True, scale, 128, 128)
    t = dict(zip("qkvbg", map(torch.from_numpy, (q, k, v, bias, g))))
    out, lse = tfa.flash_fwd(t["q"], t["k"], t["v"], t["b"], True, scale)
    dq, dk, dv = tfa._plain_flash_backward(t["q"], t["k"], t["v"], t["b"], out, lse, t["g"], True, scale)
    for a, b in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert not np.asarray(jdbias).any()  # the bias is a mask: no gradient on either side


def test_cpu_backward_takes_plain_path_and_counts_nothing():
    before = (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 9, 16), np.float32)).requires_grad_() for _ in range(3))
    (tfa.flash_attention(q, k, v) ** 2).sum().backward()
    assert all(t.grad is not None for t in (q, k, v))
    assert (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches) == before
