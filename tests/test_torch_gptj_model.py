"""GPT-J's trunk at its head width (Dh = 256) against the JAX package.

GPT-J-6B (`models/config.py::gptj_6b`: d 4096, 16 heads) attends with
Dh = 256, where the port's K1 takes its own tensor-core route and K4 its
own route on the card. Here a GPT-J-shaped config cut to CPU size keeps
that head width: d 512, 2 heads (Dh = 256), 2 layers, rotary_dim 64
interleaved, parallel FFN, untied lm_head, f32. Same weights (the flax
tree through `models/convert.py`), same numpy inputs.

Tolerance: 1e-4 abs/rel on logits and hidden states, as
tests/test_torch_model.py (XLA and ATen sum in different orders; the
measured errors are ~1e-6). Where the JAX trunk reaches its Pallas flash
kernel (no cache, T ≥ 128) it runs in interpret mode through
`_FORCE_INTERPRET`, as tests/test_torch_ops.py runs it; K1 and K4 at
Dh = 256 are also held op by op to the JAX kernels and references at the
2e-5 of tests/test_torch_ops.py. Left-padded rows are compared at real
positions only (fully masked rows hold different garbage by design).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lmrl_gym_tpu.ops.decode_attention as jda
import lmrl_gym_tpu.ops.flash_attention as jfa
from lmrl_gym_tpu.models import config as jconfig
from lmrl_gym_tpu.models import transformer as jtr
from lmrl_gym_torch.models import config as tconfig
from lmrl_gym_torch.models import transformer as ttr
from lmrl_gym_torch.models.convert import params_from_jax
from lmrl_gym_torch.ops import decode_attention as tda
from lmrl_gym_torch.ops import flash_attention as tfa
from test_torch_ppo_gate_parity import one_thread  # noqa: F401  (one intra-op thread for this module)

TOL = dict(atol=1e-4, rtol=1e-4)
OP_TOL = dict(atol=2e-5, rtol=2e-5)
NEG_BIG = -0.7 * float(np.finfo(np.float32).max)
# GPT-J's shape at CPU size: the head width (256) and every branch of gptj_6b
GPTJ_SMALL = dict(
    hidden_size=512, num_heads=2, num_layers=2, position_embedding="rotary", rotary_dim=64,
    rotary_interleaved=True, parallel_ffn=True, tie_word_embeddings=False, max_position_embeddings=256,
)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(jda, "_FORCE_INTERPRET", True)


def gptj_pair(seed=0):
    """(JAX config, JAX params, port config, port trunk) on the same weights."""
    jcfg, tcfg = jconfig.tiny_test_config(**GPTJ_SMALL), tconfig.tiny_test_config(**GPTJ_SMALL)
    assert tcfg.head_dim == 256
    jparams = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
    model = ttr.Transformer(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), tcfg))
    return jcfg, jparams, tcfg, model


def _left_padded(B, T, vocab, n_pad, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(B, T)).astype(np.int32)
    mask = (np.arange(T)[None, :] >= np.asarray(n_pad)[:, None]).astype(np.int32)
    pos = np.clip(np.cumsum(mask, axis=1) - 1, 0, None).astype(np.int32)
    return ids, mask, pos


def test_gptj_6b_config_matches_jax():
    """The full-size config the card runs: every field as the JAX
    package's, vocab 50,400 padded to 50,432, Dh = 256."""
    t, j = tconfig.gptj_6b(), jconfig.gptj_6b()
    assert {k: v for k, v in t.to_dict().items()} == {k: getattr(j, k) for k in t.to_dict()}
    assert (t.padded_vocab_size, t.head_dim, t.num_layers, t.rotary_dim) == (50432, 256, 28, 64)
    assert t.parallel_ffn and t.rotary_interleaved and not t.tie_word_embeddings


@pytest.mark.parametrize("T,n_pad", [(12, [0, 3, 7]), (128, [0, 40, 100])])
def test_full_forward_matches_jax(interpret, T, n_pad):
    """T = 128: the JAX trunk runs its Pallas flash kernel (interpret mode)."""
    jcfg, jparams, tcfg, model = gptj_pair()
    ids, mask, pos = _left_padded(3, T, jcfg.vocab_size, n_pad, seed=T)
    jl, jh, _ = jtr.Transformer(jcfg).apply(
        {"params": jparams}, jnp.asarray(ids), attention_mask=jnp.asarray(mask), position_ids=jnp.asarray(pos)
    )
    with torch.no_grad():
        tl, th, _ = model(
            torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask), position_ids=torch.from_numpy(pos).long()
        )
    real = mask.astype(bool)
    np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real], **TOL)
    np.testing.assert_allclose(th.numpy()[real], np.asarray(jh)[real], **TOL)


def test_cached_prefill_steps_and_append_match():
    """Prefill 8 (left-padded) → three 1-token steps (K4) → a 10-token
    append (K1 over the cache prefix), against the JAX cached path and the
    port's own full forward."""
    jcfg, jparams, tcfg, model = gptj_pair(seed=2)
    B, T_max = 3, 32
    total = 8 + 3 + 10
    ids, mask, pos = _left_padded(B, total, jcfg.vocab_size, [0, 2, 5], seed=3)
    mask_full = np.zeros((B, T_max), np.int32)
    mask_full[:, :total] = mask
    jcache = jtr.KVCache.init(jcfg, B, T_max)
    tcache = ttr.KVCache.init(tcfg, B, T_max, device="cpu")
    tmask = torch.from_numpy(mask_full)
    start = 0
    with torch.no_grad():
        full_logits, _, _ = model(
            torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask), position_ids=torch.from_numpy(pos).long()
        )
        for T in (8, 1, 1, 1, 10):
            jl, _, jcache = jtr.Transformer(jcfg).apply(
                {"params": jparams}, jnp.asarray(ids[:, start:start + T]), attention_mask=jnp.asarray(mask_full),
                position_ids=jnp.asarray(pos[:, start:start + T]), cache=jcache,
            )
            tl, _, tcache = model(
                torch.from_numpy(ids[:, start:start + T]).long(), attention_mask=tmask,
                position_ids=torch.from_numpy(pos[:, start:start + T]).long(), cache=tcache,
            )
            real = mask[:, start:start + T].astype(bool)
            np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real], **TOL)
            np.testing.assert_allclose(tl.numpy()[real], full_logits.numpy()[:, start:start + T][real], **TOL)
            start += T
            assert tcache.index == start == int(jcache.index)
    assert tcache.k[0].shape == (B, 2, T_max, 256)


@pytest.mark.parametrize("Tq,S,n_pad", [(10, 128, 0), (128, 128, 37), (8, 8, 0)])
def test_plain_flash_dh256_matches_jax(interpret, Tq, S, n_pad):
    """K1's plain version at Dh = 256 (the Wordle append, a prefill with a
    left-padded row, the header prefill) against the JAX XLA reference and
    its Pallas kernel (interpret mode), lse included."""
    B, H, Dh = 2, 2, 256
    rng = np.random.default_rng(Tq + S)
    q = rng.standard_normal((B, H, Tq, Dh), np.float32)
    k, v = (rng.standard_normal((B, H, S, Dh), np.float32) for _ in range(2))
    bias = np.zeros((B, S), np.float32)
    bias[1, :n_pad] = NEG_BIG
    scale = 1.0 / Dh**0.5
    jargs = tuple(map(jnp.asarray, (q, k, v, bias)))
    ref = np.asarray(jfa._xla_attention(*jargs, True, scale))
    bq = 16 if Tq < 128 else 128
    jout, jlse = jfa._flash_forward(*jargs, True, scale, bq, min(S, 128))
    out, lse = tfa.flash_fwd(*map(torch.from_numpy, (q, k, v, bias)), causal=True, sm_scale=scale)
    rows = np.ones((B, Tq), bool)
    rows[1] = np.arange(Tq) + S - Tq >= n_pad
    live = np.broadcast_to(rows[:, None, :], lse.shape)
    for other in (ref, np.asarray(jout)):
        np.testing.assert_allclose(out.numpy().transpose(0, 2, 1, 3)[rows], other.transpose(0, 2, 1, 3)[rows], **OP_TOL)
    np.testing.assert_allclose(lse.numpy()[live], np.asarray(jlse)[live], **OP_TOL)


@pytest.mark.parametrize("index,with_bias", [(0, False), (67, False), (127, True)])
def test_plain_decode_dh256_matches_jax(interpret, index, with_bias):
    """K4's plain version at Dh = 256 against the JAX Pallas decode kernel
    (interpret mode) and its XLA reference."""
    B, H, S, Dh = 3, 2, 128, 256
    rng = np.random.default_rng(index)
    q = rng.standard_normal((B, H, 1, Dh), np.float32)
    k, v = (rng.standard_normal((B, H, S, Dh), np.float32) for _ in range(2))
    bias = None
    if with_bias:
        n_pad = np.array([0, 5, index])  # key `index` stays visible
        bias = np.where(np.arange(S)[None, :] >= n_pad[:, None], 0.0, NEG_BIG).astype(np.float32)
    scale = 1.0 / Dh**0.5
    jb = None if bias is None else jnp.asarray(bias)
    kern = np.asarray(jda.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(index), jb,
                                           sm_scale=scale))
    ref = np.asarray(jda._xla_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(index), jb,
                                               scale))
    out = tda.decode_attention(*map(torch.from_numpy, (q, k, v)), index,
                               None if bias is None else torch.from_numpy(bias), scale)
    np.testing.assert_allclose(out.numpy(), kern, **OP_TOL)
    np.testing.assert_allclose(out.numpy(), ref, **OP_TOL)
