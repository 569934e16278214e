"""The port's loss functions against the JAX package's, on the same seeded
numpy inputs (f32, CPU).

Selections and masks must be equal exactly; losses and log statistics are
held to 1e-6 abs / 1e-5 rel (f32 sums over at most a few hundred terms in
different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrl_gym_tpu.algos import losses as jl
from lmrl_gym_tpu.core.logs import get_tensor_stats as jstats
from lmrl_gym_torch.algos import losses as tl
from lmrl_gym_torch.core.logs import get_tensor_stats as tstats

TOL = dict(atol=1e-6, rtol=1e-5)


def _sta(rng, b, t, p=0.4):
    """Action masks with one row of no actions and rows of several (ties
    under argmax)."""
    sta = rng.random((b, t)) < p
    sta[0] = False
    sta[1, :3] = True
    return sta


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)}


@pytest.mark.parametrize("n,p", [(40, 0.3), (17, 0.0), (9, 1.0)])
def test_select_at_mask_matches(n, p):
    rng = np.random.default_rng(n)
    values = rng.standard_normal(n).astype(np.float32)
    mask = rng.random(n) < p
    jsel, jm = jl.select_at_mask(jnp.asarray(values), jnp.asarray(mask))
    tsel, tm = tl.select_at_mask(torch.from_numpy(values), torch.from_numpy(mask))
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_select_at_mask_gradient_flows_to_selected_values():
    values = torch.arange(6, dtype=torch.float32, requires_grad=True)
    sel, _ = tl.select_at_mask(values, torch.tensor([0, 1, 0, 1, 1, 0], dtype=torch.bool))
    (sel * torch.arange(1, 7)).sum().backward()
    assert values.grad.tolist() == [0, 1, 0, 2, 3, 0]


def test_next_state_mask_matches():
    sta = _sta(np.random.default_rng(0), 6, 11)
    ref = np.asarray(jl.next_state_mask(jnp.asarray(sta)))
    np.testing.assert_array_equal(tl.next_state_mask(torch.from_numpy(sta)).numpy(), ref)


def _ilql_inputs(seed, b=5, t=11, V=32):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    sta = _sta(rng, b, t)
    attn = np.ones((b, t), np.float32)
    attn[2, -3:] = 0.0  # right padding
    return dict(
        q1=f(b, t), q2=f(b, t), v=f(b, t), v_final=f(b), target_q1=f(b, t), target_q2=f(b, t),
        q1_logits=f(b, t, V), q2_logits=f(b, t, V),
        token_ids=rng.integers(0, V, (b, t)).astype(np.int32), attention_mask=attn,
        should_take_action=sta, rewards=(-1.0 * sta).astype(np.float32),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_ilql_loss_and_every_log_term_match(seed):
    x = _ilql_inputs(seed)
    kw = dict(gamma=0.99, tau=0.7, cql_weight=0.01)
    jloss, jlogs = jl.ilql_loss(*(jnp.asarray(a) for a in x.values()), **kw)
    tloss, tlogs = tl.ilql_loss(*(torch.from_numpy(a) for a in x.values()), **kw)
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    jflat, tflat = _flat(jlogs), _flat(tlogs)
    assert set(jflat) == set(tflat)
    for name in jflat:
        np.testing.assert_allclose(tflat[name], jflat[name], err_msg=name, **TOL)


def test_ilql_loss_all_dead_batch_is_zero():
    x = _ilql_inputs(3)
    x["should_take_action"][:] = False
    loss, _ = tl.ilql_loss(*(torch.from_numpy(a) for a in x.values()), gamma=0.99, tau=0.7, cql_weight=0.01)
    assert loss.item() == 0.0


@pytest.mark.parametrize("non_train_weight", [0.0, 0.3])
def test_masked_lm_loss_matches(non_train_weight):
    rng = np.random.default_rng(7)
    b, t, V = 4, 9, 40
    logits = rng.standard_normal((b, t, V)).astype(np.float32)
    ids = rng.integers(0, V, (b, t)).astype(np.int32)
    attn = (np.arange(t)[None, :] < np.array([9, 7, 4, 9])[:, None]).astype(np.float32)
    train = (rng.random((b, t)) < 0.5).astype(np.float32)
    jloss, jlogs = jl.masked_lm_loss(*map(jnp.asarray, (logits, ids, attn, train)), non_train_weight=non_train_weight)
    tloss, tlogs = tl.masked_lm_loss(*map(torch.from_numpy, (logits, ids, attn, train)), non_train_weight=non_train_weight)
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    np.testing.assert_allclose(tlogs["loss"].item(), float(jlogs["loss"]), **TOL)


def test_optax_pieces_match():
    rng = np.random.default_rng(11)
    import optax

    x, y = rng.standard_normal((2, 3, 7)).astype(np.float32)
    np.testing.assert_allclose(tl.l2_loss(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
                               np.asarray(optax.l2_loss(x, y)), **TOL)
    labels = rng.integers(0, 7, (3,)).astype(np.int32)
    np.testing.assert_allclose(
        tl.softmax_cross_entropy_with_integer_labels(torch.from_numpy(x), torch.from_numpy(labels)).numpy(),
        np.asarray(optax.softmax_cross_entropy_with_integer_labels(x, labels)), **TOL,
    )


@pytest.mark.parametrize("shape,mask_shape", [((13,), (13,)), ((4, 6), (4, 6)), ((4, 6, 3), (4, 6))])
def test_get_tensor_stats_matches(shape, mask_shape):
    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    mask = rng.random(mask_shape) < 0.6
    n = max(float(mask.sum()), 1.0)
    ref = jstats(jnp.asarray(x), jnp.asarray(mask), n)
    got = tstats(torch.from_numpy(x), torch.from_numpy(mask), n)
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_allclose(got[k].item(), float(ref[k]), err_msg=k, **TOL)
