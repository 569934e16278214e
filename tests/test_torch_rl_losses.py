"""The port's CQL, MC and PPO losses and the PPO/MC helpers (`whiten`,
`gae_advantages_and_returns`, `reward_to_go`) against the JAX package's, on
the same seeded numpy inputs (f32, CPU).

Losses and log statistics are held to 1e-6 abs / 1e-5 rel, as in
`test_torch_losses.py` (f32 sums over at most a few hundred terms in
different orders); the reverse-scan helpers to 1e-6 abs / 1e-6 rel (the
port's reversed loop sums in the scan's order; XLA may fuse the multiply
and add).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrl_gym_tpu.algos import losses as jl
from lmrl_gym_torch.algos import losses as tl
from test_torch_losses import TOL, _flat, _sta

SCAN_TOL = dict(atol=1e-6, rtol=1e-6)


def _f(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _check(jout, tout):
    jloss, jlogs = jout
    tloss, tlogs = tout
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    jflat, tflat = _flat(jlogs), _flat(tlogs)
    assert set(jflat) == set(tflat)
    for k in jflat:
        np.testing.assert_allclose(tflat[k], jflat[k], err_msg=k, **TOL)


def _both(fn_name, arrays, **kw):
    jout = getattr(jl, fn_name)(*(jnp.asarray(a) for a in arrays), **kw)
    tout = getattr(tl, fn_name)(*(torch.from_numpy(a) for a in arrays), **kw)
    return jout, tout


@pytest.mark.parametrize("seed", [0, 1])
def test_cql_loss_matches(seed):
    rng = np.random.default_rng(seed)
    b, t, V = 5, 9, 11
    sta = _sta(rng, b, t)
    am = (rng.random((b, t)) < 0.9).astype(np.float32)
    arrays = [_f(rng, b, t), _f(rng, b, t), _f(rng, b, t), _f(rng, b, t), _f(rng, b), _f(rng, b),
              _f(rng, b, t, V), _f(rng, b, t, V), rng.integers(0, V, (b, t)).astype(np.int32), am, sta,
              (-1.0 * sta).astype(np.float32)]
    _check(*_both("cql_loss", arrays, gamma=0.99, cql_weight=0.01))


@pytest.mark.parametrize("seed", [0, 1])
def test_mc_loss_matches(seed):
    rng = np.random.default_rng(seed)
    b, t, V = 5, 9, 11
    sta = _sta(rng, b, t)
    am = (rng.random((b, t)) < 0.9).astype(np.float32)
    arrays = [_f(rng, b, t), _f(rng, b, t, V), rng.integers(0, V, (b, t)).astype(np.int32), am, sta,
              _f(rng, b, t, scale=3.0)]
    _check(*_both("mc_loss", arrays, cql_weight=0.01))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ppo_loss_matches(seed):
    rng = np.random.default_rng(seed)
    b, t = 6, 10
    sta = _sta(rng, b, t)
    am = (rng.random((b, t)) < 0.9).astype(np.float32)
    # some ratios beyond the clip range and values beyond the value clip
    arrays = [am, _f(rng, b, t, scale=0.3), _f(rng, b, t), sta, _f(rng, b, t, scale=0.3), _f(rng, b, t),
              _f(rng, b, t), _f(rng, b, t)]
    _check(*_both("ppo_loss", arrays, cliprange_value=0.2, cliprange=0.2, value_loss_coef=0.5))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shift_mean", [True, False])
def test_whiten_matches(masked, shift_mean):
    rng = np.random.default_rng(4)
    x = _f(rng, 7, 13, scale=2.5) + 1.5
    mask = (rng.random((7, 13)) < 0.6).astype(np.float32) if masked else None
    ref = jl.whiten(jnp.asarray(x), None if mask is None else jnp.asarray(mask), shift_mean=shift_mean)
    got = tl.whiten(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask), shift_mean=shift_mean)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_whiten_without_mask_has_ddof_0():
    x = torch.tensor([1.0, 2.0, 3.0, 4.0])
    out = tl.whiten(x)
    assert torch.allclose(out.pow(2).mean(), torch.tensor(1.0), atol=1e-6)


@pytest.mark.parametrize("use_whitening", [False, True])
@pytest.mark.parametrize("gamma,lam", [(1.0, 0.95), (0.99, 0.9)])
def test_gae_matches(use_whitening, gamma, lam):
    rng = np.random.default_rng(5)
    sv, nsv, r = _f(rng, 3, 17), _f(rng, 3, 17), _f(rng, 3, 17)
    ja, jr = jl.gae_advantages_and_returns(jnp.asarray(sv), jnp.asarray(nsv), jnp.asarray(r), gamma=gamma, lam=lam,
                                           use_whitening=use_whitening)
    ta, tr = tl.gae_advantages_and_returns(torch.from_numpy(sv), torch.from_numpy(nsv), torch.from_numpy(r),
                                           gamma=gamma, lam=lam, use_whitening=use_whitening)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **(TOL if use_whitening else SCAN_TOL))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **SCAN_TOL)


@pytest.mark.parametrize("gamma", [1.0, 0.99, 0.5])
def test_reward_to_go_matches(gamma):
    rng = np.random.default_rng(6)
    r = _f(rng, 4, 23)
    ref = jl.reward_to_go(jnp.asarray(r), gamma=gamma)
    got = tl.reward_to_go(torch.from_numpy(r), gamma=gamma)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **SCAN_TOL)
