"""Attention-probability dropout in training: the port's einsum route
(`lmrl_gym_torch/models/transformer.py::attention_with_dropout`) against
the JAX package's (`lmrl_gym_tpu/models/transformer.py:236-243`).

The JAX forward runs with `deterministic=False`, `attn_pdrop` 0.1 and 0.5
and the other dropout rates 0; `flax.linen.intercept_methods` records each
`nn.Dropout.__call__`'s output, and the keep mask is where it is non-zero
(a zero probability — a masked key — is zero either way). Those masks,
one per layer, are replayed into the port through `attn_keep`. Outputs and
parameter gradients match at 1e-4 abs/rel (f32, as
tests/test_torch_train_forward.py), a right-padded row included. Drawn from
a generator, the keep share is 1 − rate ± 0.005, and no K1, K2 or K3 runs
on such a step: their plain versions, which the CPU takes, are wrapped to
count calls.
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrl_gym_tpu.models.config import tiny_test_config as jtiny
from lmrl_gym_tpu.models.transformer import Transformer as JTransformer
from lmrl_gym_tpu.models.transformer import init_params
from lmrl_gym_torch.models.config import tiny_test_config as ttiny
from lmrl_gym_torch.models.convert import params_from_jax
from lmrl_gym_torch.models import transformer as tmod
from lmrl_gym_torch.models.transformer import Transformer
from lmrl_gym_torch.ops import flash_attention as flash_module

TOL = dict(atol=1e-4, rtol=1e-4)
PAD = 256


def _inputs(B=3, T=14, seed=0):
    ids = np.random.default_rng(seed).integers(1, 256, (B, T)).astype(np.int32)
    ids[1, 9:] = PAD  # a right-padded row
    w = np.random.default_rng(seed + 1).standard_normal((B, T, 320)).astype(np.float32)
    return ids, (ids != PAD).astype(np.int32), w


def _jax_loss(jcfg, params, ids, mask, w, key):
    logits, _, _ = JTransformer(jcfg).apply({"params": params}, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                                            deterministic=False, rngs={"dropout": key})
    return jnp.sum(logits * w), logits


def _jax_keep_masks(jcfg, params, ids, mask, w, key):
    """Each attention dropout's keep mask from a recorded forward on `key`."""
    outs = []

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
            outs.append(np.asarray(out))
        return out

    with nn.intercept_methods(interceptor):
        _jax_loss(jcfg, params, ids, mask, w, key)
    return [torch.from_numpy(o != 0) for o in outs]


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_attention_dropout_matches_jax_on_replayed_masks(rate):
    jcfg, tcfg = jtiny(attn_pdrop=rate), ttiny(attn_pdrop=rate)
    params = init_params(jcfg, jax.random.PRNGKey(4))
    ids, mask, w = _inputs()
    key = jax.random.PRNGKey(9)
    keeps = _jax_keep_masks(jcfg, params, ids, mask, w, key)
    B, T = ids.shape
    assert len(keeps) == jcfg.num_layers and keeps[0].shape == (B, jcfg.num_heads, T, T)
    (jloss, jlogits), jgrads = jax.value_and_grad(
        lambda p: _jax_loss(jcfg, p, ids, mask, w, key), has_aux=True)(params)

    model = Transformer(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tcfg))
    logits, _, _ = model(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask), deterministic=False,
                         attn_keep=keeps)
    loss = (logits * torch.from_numpy(w)).sum()
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name, **TOL)
    # the masks are what made the difference: without dropout the output moves
    plain, _, _ = model(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask))
    assert not torch.allclose(plain, logits.detach(), **TOL)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_attention_dropout_keep_share_and_no_flash_launch(rate, monkeypatch):
    calls = {"fwd": 0, "dq": 0, "dkv": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(flash_module, "_plain_attention", counted("fwd", flash_module._plain_attention))
    monkeypatch.setattr(flash_module, "_plain_bwd_dq", counted("dq", flash_module._plain_bwd_dq))
    monkeypatch.setattr(flash_module, "_plain_bwd_dkv", counted("dkv", flash_module._plain_bwd_dkv))
    cfg = ttiny(attn_pdrop=rate, max_position_embeddings=256)
    model = Transformer(cfg, device="cpu", seed=2)
    ids = torch.from_numpy(np.random.default_rng(3).integers(1, 256, (8, 200))).long()
    gen = torch.Generator().manual_seed(0)
    draws = []
    orig_dropout = tmod.dropout

    def spy(x, rate, generator=None, keep=None):
        y = orig_dropout(x, rate, generator, keep)
        draws.append(y != 0)
        return y

    monkeypatch.setattr(tmod, "dropout", spy)
    logits, _, _ = model(ids, deterministic=False, generator=gen)
    logits.sum().backward()
    assert calls == {"fwd": 0, "dq": 0, "dkv": 0}
    assert len(draws) == cfg.num_layers
    # the keep share over the causal entries, where every probability is non-zero
    T = ids.shape[1]
    causal = torch.ones(T, T, dtype=torch.bool).tril()
    share = torch.stack([d[:, :, causal] for d in draws]).float().mean().item()
    assert abs(share - (1 - rate)) < 0.005
    # inference ignores the rate and takes K1's route
    model(ids[:2])
    assert calls["fwd"] == cfg.num_layers
