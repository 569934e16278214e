"""The model's attention route against the JAX package's, on the CPU.

The JAX model (`lmrl_gym_tpu/models/transformer.py:225-252`) takes its
einsum attention whenever `use_flash_attention` is off or `supports_flash`
refuses the shape (Dh not a multiple of 8, or above 256), so it runs any
head dim. The port chooses its route up front the same way
(`Attention.forward`: `kernels_take`), so a config whose head dim the
kernels refuse, or whose flag is off, runs the einsum route
(`attention_einsum`) on every attention call: no-cache forwards, cached
prefills and cached single-token steps. The choice is by config and shape,
not device, so it shows here: `attention_einsum.calls` moves by one per
layer and call, and the kernels' wrappers are never called.

Same weights (models/convert.py), same numpy inputs; logits compared at
real positions within 1e-4 abs/rel (f32, as tests/test_torch_model.py:
summation order only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lmrl_gym_tpu.ops.flash_attention as jfa
from lmrl_gym_tpu.models import transformer as jtr
from lmrl_gym_tpu.models.config import tiny_test_config as jtiny
from lmrl_gym_torch.models import transformer as ttr
from lmrl_gym_torch.models.config import tiny_test_config as ttiny
from lmrl_gym_torch.models.convert import params_from_jax
from lmrl_gym_torch.ops import flash_attention as tfa
from test_torch_ppo_gate_parity import one_thread  # noqa: F401  (one intra-op thread for this module)

TOL = dict(atol=1e-4, rtol=1e-4)

# Dh = 28: hidden 224 over 8 heads (not a multiple of 8); and a Dh = 16 config
# with the kernels switched off
CASES = {
    "dh28": dict(hidden_size=224, num_heads=8),
    "dh28_rotary": dict(hidden_size=224, num_heads=8, position_embedding="rotary", rotary_dim=12,
                        rotary_interleaved=True, parallel_ffn=True, tie_word_embeddings=False),
    "flash_off": dict(use_flash_attention=False),
}


def _pair(kw, seed=0):
    jcfg, tcfg = jtiny(**kw), ttiny(**kw)
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


@pytest.fixture
def no_kernels(monkeypatch):
    """The model's kernel entry points raise if called; the einsum counter
    starts at 0."""
    def refuse(*a, **kw):
        raise AssertionError("a kernel route was taken")

    monkeypatch.setattr(ttr, "flash_attention", refuse)
    monkeypatch.setattr(ttr, "decode_attention", refuse)
    monkeypatch.setattr(ttr.attention_einsum, "calls", 0)


@pytest.mark.parametrize("case", list(CASES))
def test_full_forward_takes_einsum_route(no_kernels, case):
    jcfg, jparams, tcfg, model = _pair(CASES[case])
    assert not (tcfg.use_flash_attention and tfa.kernels_take(tcfg.head_dim, torch.float32))
    ids, mask, pos = _left_padded(3, 20, jcfg.vocab_size, [0, 3, 11], seed=1)
    jl, _, _ = jtr.Transformer(jcfg).apply(
        {"params": jparams}, jnp.asarray(ids), attention_mask=jnp.asarray(mask), position_ids=jnp.asarray(pos)
    )
    with torch.no_grad():
        tl, _, _ = model(
            torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask), position_ids=torch.from_numpy(pos).long()
        )
    assert ttr.attention_einsum.calls == tcfg.num_layers
    real = mask.astype(bool)
    np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real], **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_cached_prefill_steps_and_append_take_einsum_route(no_kernels, case):
    """Prefill 8 (left-padded) → three 1-token steps → a 10-token append,
    against the JAX cached path (over its whole T_max buffer) and the port's
    own full forward: every call runs the einsum route in every layer."""
    jcfg, jparams, tcfg, model = _pair(CASES[case], seed=2)
    B, T_max = 3, 32
    total = 8 + 3 + 10
    ids, mask, pos = _left_padded(B, total, jcfg.vocab_size, [0, 2, 5], seed=3)
    mask_full = np.zeros((B, T_max), np.int32)
    mask_full[:, :total] = mask
    jcache = jtr.KVCache.init(jcfg, B, T_max)
    tcache = ttr.KVCache.init(tcfg, B, T_max, device="cpu")
    tmask = torch.from_numpy(mask_full)
    start, n_calls = 0, 0
    with torch.no_grad():
        full_logits, _, _ = model(
            torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask), position_ids=torch.from_numpy(pos).long()
        )
        n_calls += 1
        for T in (8, 1, 1, 1, 10):
            jl, _, jcache = jtr.Transformer(jcfg).apply(
                {"params": jparams}, jnp.asarray(ids[:, start:start + T]), attention_mask=jnp.asarray(mask_full),
                position_ids=jnp.asarray(pos[:, start:start + T]), cache=jcache,
            )
            tl, _, tcache = model(
                torch.from_numpy(ids[:, start:start + T]).long(), attention_mask=tmask,
                position_ids=torch.from_numpy(pos[:, start:start + T]).long(), cache=tcache,
            )
            n_calls += 1
            assert ttr.attention_einsum.calls == n_calls * tcfg.num_layers
            real = mask[:, start:start + T].astype(bool)
            np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real], **TOL)
            np.testing.assert_allclose(tl.numpy()[real], full_logits.numpy()[:, start:start + T][real], **TOL)
            start += T
            assert tcache.index == start == int(jcache.index)


def test_float16_model_takes_einsum_route(no_kernels, monkeypatch):
    """float16 is neither f32 nor bf16: the kernels refuse it, so every call
    runs the einsum route, and the logits stay near the same weights' f32
    logits (float16 keeps ~3 decimal digits per op)."""
    _, _, _, model = _pair({})
    half = ttr.Transformer(ttiny(dtype="float16"), device="cpu")
    half.load_state_dict(model.state_dict())
    ids, mask, pos = _left_padded(2, 12, 259, [0, 4], seed=4)
    args = dict(attention_mask=torch.from_numpy(mask), position_ids=torch.from_numpy(pos).long())
    with torch.no_grad():
        got = half(torch.from_numpy(ids).long(), **args)[0]
        assert ttr.attention_einsum.calls == half.config.num_layers
        monkeypatch.setattr(ttr, "flash_attention", tfa.flash_attention)  # the f32 model: the kernels' route
        ref = model(torch.from_numpy(ids).long(), **args)[0]
    assert ttr.attention_einsum.calls == half.config.num_layers
    assert got.dtype == torch.float16
    real = mask.astype(bool)
    np.testing.assert_allclose(got.float().numpy()[real], ref.numpy()[real], atol=2e-2, rtol=2e-2)


def test_kernel_configs_keep_the_kernel_route(monkeypatch):
    """A config the kernels take (Dh = 16, f32, the flag on) never reaches
    the einsum route, cached or not."""
    monkeypatch.setattr(ttr.attention_einsum, "calls", 0)
    _, _, tcfg, model = _pair({})
    ids, mask, pos = _left_padded(2, 10, 259, [0, 3], seed=5)
    cache = ttr.KVCache.init(tcfg, 2, 16, device="cpu")
    with torch.no_grad():
        model(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask))
        full = torch.zeros(2, 16, dtype=torch.int32)
        full[:, :10] = torch.from_numpy(mask)
        full[:, 10] = 1
        _, _, cache = model(torch.from_numpy(ids).long(), attention_mask=full, position_ids=torch.from_numpy(pos).long(),
                            cache=cache)
        model(torch.tensor([[1], [2]]), attention_mask=full, position_ids=torch.tensor([[10], [8]]), cache=cache)
    assert ttr.attention_einsum.calls == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_kernels_take_agrees_with_reference_head_dim_rule(monkeypatch, dtype):
    """`kernels_take` is the reference's `supports_flash` head-dim rule
    (checked with the JAX kernels forced into interpret mode, at a length
    it takes), for the dtypes the kernels are built for; float16 never."""
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)
    for dh in range(1, 300):
        ref = jfa.supports_flash((2, 4, 128, dh), 128)
        assert tfa.kernels_take(dh, dtype) == (ref and dtype != torch.float16), dh


def test_wrappers_still_refuse_what_the_route_avoids():
    """Called directly, the wrappers' checks are unchanged: a Dh = 28 or a
    float16 input on a CUDA tensor raises before any launch. Here (no card)
    the wrappers' check is called on CPU tensors: it refuses the head dim
    and the dtype before it looks at the device."""
    q = torch.zeros(1, 2, 4, 28)
    with pytest.raises(ValueError):
        tfa._check_cuda_inputs(q, q, q, None)
    h = torch.zeros(1, 2, 4, 32, dtype=torch.float16)
    with pytest.raises(TypeError):
        tfa._check_cuda_inputs(h, h, h, None)
