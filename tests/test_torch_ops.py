"""The port's attention ops against the JAX package's.

On the CPU each wrapper takes its plain PyTorch version; these tests hold
that version to the JAX package's XLA reference and to its Pallas kernel
run in interpret mode (as tests/test_ops.py and
tests/test_decode_attention.py run them). Tolerance: 2e-5 abs/rel in f32,
as the JAX tests use between kernel and reference — XLA and ATen sum the
Dh-long dot products and the softmax in different orders.

The kernels themselves are held against these plain versions on the card
by tests/test_torch_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lmrl_gym_tpu.ops.decode_attention as jda
import lmrl_gym_tpu.ops.flash_attention as jfa
from lmrl_gym_torch.ops import decode_attention as tda
from lmrl_gym_torch.ops import flash_attention as tfa

NEG_BIG = -0.7 * float(np.finfo(np.float32).max)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(jda, "_FORCE_INTERPRET", True)


def _qkv(B, H, Tq, S, Dh, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((B, H, Tq, Dh), np.float32),
        rng.standard_normal((B, H, S, Dh), np.float32),
        rng.standard_normal((B, H, S, Dh), np.float32),
    )


@pytest.mark.parametrize(
    "B,H,Tq,S,Dh",
    [
        (1, 2, 128, 128, 64),
        (2, 1, 200, 200, 32),  # non-multiple of the block
        (1, 1, 128, 256, 64),  # Tq < S: queries right-aligned (decode layout)
    ],
)
def test_plain_flash_matches_jax(interpret, B, H, Tq, S, Dh):
    q, k, v = _qkv(B, H, Tq, S, Dh, seed=Tq + S)
    maskrow = np.where(np.arange(S) < S - 5, 0.0, NEG_BIG).astype(np.float32)
    bias = np.stack([maskrow] + [np.zeros(S, np.float32)] * (B - 1))
    scale = 1.0 / Dh**0.5
    ref = np.asarray(jfa._xla_attention(*map(jnp.asarray, (q, k, v, bias)), True, scale))
    kern = np.asarray(jfa.flash_attention(*map(jnp.asarray, (q, k, v, bias)), causal=True, block_q=128, block_k=128))
    out, lse = tfa.flash_fwd(*map(torch.from_numpy, (q, k, v, bias)), causal=True, sm_scale=scale)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), kern, atol=2e-5, rtol=2e-5)
    # the logsumexp the Pallas kernel saves for its backward
    _, jlse = jfa._flash_forward(*map(jnp.asarray, (q, k, v, bias)), True, scale, 128, 128)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=2e-5, rtol=2e-5)


def test_plain_flash_no_bias_non_causal(interpret):
    q, k, v = _qkv(1, 2, 128, 128, 64, seed=3)
    ref = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), None, causal=False, block_q=128, block_k=128)
    out = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), None, causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


def _decode_inputs(B, H, Tq, S, Dh, index, seed, with_bias=True):
    """As tests/test_decode_attention.py: slots past the fill are zeros, and
    a random left-padding bias over the filled prefix."""
    q, k, v = _qkv(B, H, Tq, S, Dh, seed)
    live = (np.arange(S) < index + Tq)[None, None, :, None]
    k, v = k * live, v * live
    bias = None
    if with_bias:
        npad = np.random.default_rng(seed + 1).integers(0, max(1, index), size=B)
        bias = np.where(np.arange(S)[None, :] >= npad[:, None], 0.0, NEG_BIG).astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize(
    "Tq,index,block_k",
    [(1, 37, 32), (1, 0, 64), (10, 8, 32), (8, 0, 64), (10, 118, 32)],
)
def test_plain_decode_matches_jax(interpret, Tq, index, block_k):
    B, H, S, Dh = 3, 4, 128, 64
    q, k, v, bias = _decode_inputs(B, H, Tq, S, Dh, index, seed=Tq * 1000 + index)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(index, jnp.int32), jnp.asarray(bias))
    ref = np.asarray(jda._xla_decode_attention(*jargs, 0.125))
    kern = np.asarray(jda.decode_attention(*jargs, sm_scale=0.125, block_k=block_k))
    out = tda.decode_attention(*map(torch.from_numpy, (q, k, v)), index, torch.from_numpy(bias), sm_scale=0.125)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), kern, atol=2e-5, rtol=2e-5)


def test_plain_decode_no_bias_bf16(interpret):
    """bf16 inputs: both sides round probs and output to bf16; 2e-2 covers
    one bf16 ulp at |x| < 4 (as tests/test_decode_attention.py)."""
    q, k, v, _ = _decode_inputs(2, 3, 1, 64, 64, 20, seed=7, with_bias=False)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = jda.decode_attention(jq, jk, jv, jnp.asarray(20, jnp.int32), None, sm_scale=0.125, block_k=32)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    out = tda.decode_attention(tq, tk, tv, 20, None, sm_scale=0.125)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=2e-2)


def test_cpu_wrappers_take_plain_path_and_count_nothing():
    before = (tfa.flash_fwd.launches, tda.decode_attention.launches)
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 2, 4, 16, 32, seed=1))
    out, lse = tfa.flash_fwd(q, k, v, None)
    ref, ref_lse = tfa._plain_attention(q, k, v, None, True, 1.0 / 32**0.5)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    dec = tda.decode_attention(q[:, :, :1], k, v, 9, None, 0.2)
    assert torch.equal(dec, tda._plain_decode_attention(q[:, :, :1], k, v, 9, None, 0.2))
    assert (tfa.flash_fwd.launches, tda.decode_attention.launches) == before
