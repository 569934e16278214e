"""The port's training forward: `LMCore.forward(train=True)`, dropout in the
trunk and the MLP head, and the route attention-probability dropout takes.

With dropout rates 0 the training forward computes the inference function
and must match the JAX package's `train=True` forward (1e-4 abs/rel, f32,
as tests/test_torch_model.py). Dropout masks come from a torch.Generator
and cannot match jax.random's bits, so dropout is held to its definition
(flax's `nn.Dropout`): each element kept with probability 1 − rate and
scaled by 1/(1 − rate), the same generator state giving the same masks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrl_gym_tpu.models.config import tiny_test_config as jtiny
from lmrl_gym_tpu.models.interface import LMCore as JCore
from lmrl_gym_tpu.models.transformer import init_params
from lmrl_gym_torch.models.config import tiny_test_config as ttiny
from lmrl_gym_torch.models.convert import params_from_jax
from lmrl_gym_torch.models.heads import MLPHead, MLPHeadConfig
from lmrl_gym_torch.models.interface import LMCore as TCore
from lmrl_gym_torch.models import transformer as tmod
from lmrl_gym_torch.models.transformer import Transformer, dropout

TOL = dict(atol=1e-4, rtol=1e-4)


def _ids(B=3, T=14, seed=0):
    return np.random.default_rng(seed).integers(1, 256, (B, T)).astype(np.int32)


def test_training_forward_matches_jax_and_carries_gradients():
    jcfg, tcfg = jtiny(), ttiny()
    jparams = init_params(jcfg, jax.random.PRNGKey(2))
    model = Transformer(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), tcfg))
    ids = _ids()
    jl, jh = JCore(jcfg).forward(jparams, jnp.asarray(ids), pad_token_id=256, train=True, rng=jax.random.PRNGKey(0))
    tl, th = TCore(tcfg, device="cpu").forward(model, torch.from_numpy(ids), pad_token_id=256, train=True)
    assert th.requires_grad and th.grad_fn is not None
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), **TOL)
    _, th_eval = TCore(tcfg, device="cpu").forward(model, torch.from_numpy(ids), pad_token_id=256, train=False)
    assert not th_eval.requires_grad
    torch.testing.assert_close(th_eval, th.detach())


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keeps_one_minus_rate_and_rescales(rate):
    x = torch.ones(200_000)
    y = dropout(x, rate, torch.Generator().manual_seed(0))
    kept = y != 0
    assert torch.all(y[kept] == 1.0 / (1.0 - rate))
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.005


def test_trunk_dropout_follows_the_generator():
    cfg = ttiny(embd_pdrop=0.1, resid_pdrop=0.1)
    model = Transformer(cfg, device="cpu", seed=3)
    ids = torch.from_numpy(_ids(seed=1)).long()

    def run(seed, deterministic=False):
        gen = torch.Generator().manual_seed(seed)
        return model(ids, deterministic=deterministic, generator=gen)[1]

    torch.testing.assert_close(run(0), run(0), rtol=0, atol=0)
    assert not torch.allclose(run(0), run(1))
    torch.testing.assert_close(run(0, deterministic=True), run(1, deterministic=True), rtol=0, atol=0)
    with pytest.raises(ValueError, match="generator"):
        model(ids, deterministic=False)


def test_attention_dropout_in_training_is_refused():
    """(Its name kept from when the port refused this dropout.) Training
    with attn_pdrop > 0 takes the einsum route, `attention_einsum` with a
    `drop`, drawing its masks from the generator; inference ignores the rate."""
    model = Transformer(ttiny(attn_pdrop=0.1), device="cpu")
    ids = torch.from_numpy(_ids()).long()
    with pytest.raises(ValueError, match="generator"):
        model(ids, deterministic=False)
    routes = []
    orig = tmod.attention_einsum

    def spy(*a, **kw):
        routes.append(1)
        return orig(*a, **kw)

    tmod.attention_einsum = spy
    try:
        a = model(ids, deterministic=False, generator=torch.Generator().manual_seed(0))[0]
        b = model(ids, deterministic=False, generator=torch.Generator().manual_seed(0))[0]
        c = model(ids, deterministic=False, generator=torch.Generator().manual_seed(1))[0]
        assert len(routes) == 3 * model.config.num_layers
        ref = model(ids)[0]  # inference ignores every dropout rate
        assert len(routes) == 3 * model.config.num_layers
    finally:
        tmod.attention_einsum = orig
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c) and not torch.allclose(a, ref)
    torch.testing.assert_close(model(ids, deterministic=True, generator=torch.Generator())[0], ref, rtol=0, atol=0)


def test_mlp_head_dropout_only_in_training():
    head = MLPHead(MLPHeadConfig(8, 32, 5, dropout=0.5), device="cpu", seed=1)
    x = torch.randn(4, 3, 8, generator=torch.Generator().manual_seed(0))
    ref = head(x)
    torch.testing.assert_close(head(x, deterministic=True, generator=torch.Generator().manual_seed(1)), ref)
    a = head(x, deterministic=False, generator=torch.Generator().manual_seed(1))
    b = head(x, deterministic=False, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, ref)
    with pytest.raises(ValueError, match="generator"):
        head(x, deterministic=False)
