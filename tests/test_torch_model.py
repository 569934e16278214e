"""The port's trunk, heads and weight converter against the JAX package.

Same weights (the flax tree carried over by models/convert.py), same
inputs made with numpy from a seed. Tolerance: 1e-4 abs/rel on logits and
hidden states after 2 layers in f32 (XLA and ATen sum matmuls and the
layernorm statistics in different orders; measured errors are ~1e-6).
Left-padded rows are compared at real positions only: fully masked pad
queries hold different garbage in the einsum and kernel paths by design
(finfo.min vs −0.7·f32max masking).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrl_gym_tpu.models import heads as jheads
from lmrl_gym_tpu.models import transformer as jtr
from lmrl_gym_tpu.models.config import tiny_test_config as jtiny
from lmrl_gym_torch.models import heads as theads
from lmrl_gym_torch.models import transformer as ttr
from lmrl_gym_torch.models.config import tiny_test_config as ttiny
from lmrl_gym_torch.models.convert import head_params_from_jax, params_from_jax
from test_torch_ppo_gate_parity import one_thread  # noqa: F401  (one intra-op thread for this module)

TOL = dict(atol=1e-4, rtol=1e-4)

VARIANTS = {
    "gpt2": {},
    "gptj": dict(
        position_embedding="rotary", rotary_dim=8, rotary_interleaved=True,
        parallel_ffn=True, tie_word_embeddings=False,
    ),
    "llama": dict(
        position_embedding="rotary", norm="rmsnorm", gated_mlp=True, activation="silu",
        attn_bias=False, mlp_bias=False, lm_head_bias=False, tie_word_embeddings=False,
    ),
    "neox_gelu": dict(position_embedding="rotary", activation="gelu"),
}


def _pair(variant, seed=0):
    kw = VARIANTS[variant]
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


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_full_forward_matches_jax(variant):
    jcfg, jparams, tcfg, model = _pair(variant)
    ids, mask, pos = _left_padded(3, 12, jcfg.vocab_size, [0, 3, 7], seed=1)
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


def _jax_cached(jcfg, jparams, ids, mask_full, pos, cache, start, T):
    return jtr.Transformer(jcfg).apply(
        {"params": jparams}, jnp.asarray(ids[:, start:start + T]), attention_mask=jnp.asarray(mask_full),
        position_ids=jnp.asarray(pos[:, start:start + T]), cache=cache,
    )


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cached_prefill_steps_and_append_match(variant):
    """Prefill 8 (left-padded) → three 1-token steps → a 10-token append,
    against the JAX cached path and the port's own full forward."""
    jcfg, jparams, tcfg, model = _pair(variant, seed=2)
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
            jl, _, jcache = _jax_cached(jcfg, jparams, ids, mask_full, pos, jcache, start, T)
            tl, _, tcache = model(
                torch.from_numpy(ids[:, start:start + T]).long(), attention_mask=tmask,
                position_ids=torch.from_numpy(pos[:, start:start + T]).long(), cache=tcache,
            )
            real = mask[:, start:start + T].astype(bool)
            np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real], **TOL)
            np.testing.assert_allclose(tl.numpy()[real], full_logits.numpy()[:, start:start + T][real], **TOL)
            start += T
            assert tcache.index == start == int(jcache.index)


def test_converter_keeps_padded_vocab_rows():
    jcfg, jparams, tcfg, model = _pair("gpt2")
    wte = np.asarray(jparams["wte"]["embedding"])
    assert wte.shape == (tcfg.padded_vocab_size, tcfg.hidden_size)
    assert tcfg.padded_vocab_size > tcfg.vocab_size
    np.testing.assert_array_equal(model.wte.weight.detach().numpy(), wte)
    # nn.Linear holds the transposed flax kernel
    np.testing.assert_array_equal(
        model.h[0].attn.qkv.weight.detach().numpy(), np.asarray(jparams["h_0"]["attn"]["qkv"]["kernel"]).T
    )


def test_mask_pad_logits_matches():
    logits = np.random.default_rng(0).standard_normal((2, 3, 320)).astype(np.float32)
    ref = np.asarray(jtr.mask_pad_logits(jnp.asarray(logits), 259))
    np.testing.assert_array_equal(ttr.mask_pad_logits(torch.from_numpy(logits), 259).numpy(), ref)


@pytest.mark.parametrize(
    "kind,kw",
    [
        ("mlp", dict(input_dim=64, hidden_dim=128, output_dim=320)),
        ("mlp", dict(input_dim=64, hidden_dim=128, output_dim=320, layer2_initializer_range=0.0, layer2_bias_init=-0.5)),
        ("mlp", dict(input_dim=64, hidden_dim=128, output_dim=1, activation="relu")),
        ("linear", dict(input_dim=64, output_dim=1, bias_init=-4.1)),
    ],
)
def test_heads_match_jax(kind, kw):
    if kind == "mlp":
        jhead, tcls, tcfg = jheads.MLPHead(jheads.MLPHeadConfig(**kw)), theads.MLPHead, theads.MLPHeadConfig(**kw)
    else:
        jhead, tcls, tcfg = jheads.LinearHead(jheads.LinearHeadConfig(**kw)), theads.LinearHead, theads.LinearHeadConfig(**kw)
    jp = jheads.init_head_params(jhead, kw["input_dim"], jax.random.PRNGKey(4))
    head = tcls(tcfg, device="cpu")
    sd = head_params_from_jax(jax.tree.map(np.asarray, jp))
    # the port's own init follows the same rules: zero layer 2 and constant biases
    for name, value in head.state_dict().items():
        if name.endswith("bias") or kw.get("layer2_initializer_range") == 0.0 and name == "dense2.weight":
            np.testing.assert_array_equal(value.numpy(), sd[name].numpy())
    head.load_state_dict(sd)
    x = np.random.default_rng(5).standard_normal((2, 3, kw["input_dim"])).astype(np.float32)
    ref = np.asarray(jhead.apply({"params": jp}, jnp.asarray(x)))
    with torch.no_grad():
        out = head(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_positions_past_the_table_read_nan_as_jax():
    """flax's `Embed` looks positions up with `jnp.take` in "fill" mode:
    a position at or past max_position_embeddings reads NaN (a long prompt
    plus its new tokens, as the dialog gates' LM buyer can reach); the
    port's lookup (`take_fill`) does the same where a CUDA gather would
    assert. Rows before it agree; rows from it on are NaN in both."""
    jcfg, jparams, tcfg, model = _pair("gpt2")
    T, P = 6, jcfg.max_position_embeddings
    ids = np.random.default_rng(2).integers(0, jcfg.vocab_size, size=(2, T)).astype(np.int32)
    pos = np.stack([np.arange(T), np.arange(P - 3, P - 3 + T)]).astype(np.int32)
    jl, _, _ = jtr.Transformer(jcfg).apply({"params": jparams}, jnp.asarray(ids), position_ids=jnp.asarray(pos))
    with torch.no_grad():
        tl, _, _ = model(torch.from_numpy(ids).long(), position_ids=torch.from_numpy(pos).long())
    jl, tl = np.asarray(jl), tl.numpy()
    assert np.isnan(jl[1, 3:]).all() and np.isnan(tl[1, 3:]).all()
    np.testing.assert_allclose(tl[0], jl[0], **TOL)
    np.testing.assert_allclose(tl[1, :3], jl[1, :3], **TOL)
