"""The port's optimizer pieces against optax, over 5 steps on one seeded
parameter tree (f32, CPU).

Each step feeds both the same numpy gradients and compares the updates
(not the parameters, where rounding p + u hides the update's low bits):
1e-6 relative, elementwise, with an absolute floor of 1e-6 of the tensor's
largest update. The floor covers elements whose update is near zero after a
cancellation (weight decay against the Adam step, a clipped gradient one
ulp off from a differently ordered global norm), where one ulp of an input
is a large relative error of the output. Schedules are compared value by
value at 1e-6 relative (optax evaluates them in f32, the port in f64).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lmrl_gym_tpu.core import optimizer as jopt
from lmrl_gym_tpu.models.config import tiny_test_config as jtiny
from lmrl_gym_tpu.models.transformer import init_params
from lmrl_gym_torch.core import optimizer as topt
from lmrl_gym_torch.models.config import tiny_test_config as ttiny
from lmrl_gym_torch.models.convert import params_from_jax
from lmrl_gym_torch.models.transformer import Transformer

RTOL = 1e-6
SHAPES = {"dense/kernel": (6, 5), "dense/bias": (5,), "ln_1/scale": (5,), "wte/embedding": (7, 5)}
STEPS = 5


def _tree(flat):
    tree = {}
    for path, a in flat.items():
        mod, leaf = path.split("/")
        tree.setdefault(mod, {})[leaf] = jnp.asarray(a)
    return tree


def _unflat(tree):
    return {f"{m}/{k}": np.asarray(a) for m, d in tree.items() for k, a in d.items()}


def _run(jtx, ttx, grad_scale=1.0, seed=0):
    """Drive both for STEPS steps; → list of (jax updates, port updates)."""
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    jp = _tree(params)
    tp = {k.replace("/", "."): torch.from_numpy(a.copy()) for k, a in params.items()}
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    out = []
    for _ in range(STEPS):
        grads = {k: (grad_scale * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
        ju, jstate = jtx.update(_tree(grads), jstate, jp)
        tu, tstate = ttx.update({k.replace("/", "."): torch.from_numpy(g.copy()) for k, g in grads.items()}, tstate, tp)
        jp = optax.apply_updates(jp, ju)
        topt.apply_updates(tp, tu)
        ju = _unflat(ju)
        out.append(({k.replace("/", "."): v for k, v in ju.items()}, {k: v.numpy().copy() for k, v in tu.items()}, tstate))
    return out


def _assert_updates_match(steps):
    for i, (ju, tu, _) in enumerate(steps):
        assert set(ju) == set(tu)
        for k in ju:
            atol = RTOL * float(np.abs(ju[k]).max()) if ju[k].size else 0.0
            np.testing.assert_allclose(tu[k], ju[k], rtol=RTOL, atol=atol, err_msg=f"step {i} {k}")


@pytest.mark.parametrize(
    "name,make",
    [
        ("adam", lambda o: o.adam(1e-3)),
        ("adam_b2_095", lambda o: o.adam(3e-4, b1=0.9, b2=0.95)),
        ("adamw_default_decay", lambda o: o.adamw(1e-3)),
        ("adamw_masked", lambda o: o.adamw(1e-3, weight_decay=0.1, mask=_mask(o))),
        ("set_to_zero", lambda o: o.set_to_zero()),
        ("adam_warmup_cosine", lambda o: o.adam(o.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 5, 1e-4))),
    ],
)
def test_transformations_match_optax(name, make):
    _assert_updates_match(_run(make(optax), make(topt)))


def _mask(o):
    """The same leaves masked on both sides: optax takes a tree, the port a
    dict by name."""
    if o is optax:
        return lambda params: jopt.weight_decay_mask(params)
    return lambda params: topt.weight_decay_mask(params)


@pytest.mark.parametrize("grad_scale,clipped", [(0.05, False), (10.0, True)])
def test_clip_by_global_norm_matches(grad_scale, clipped):
    """Below the threshold the gradients pass unchanged; above it they are
    scaled to norm 1 (no epsilon, unlike torch's clip_grad_norm_)."""
    steps = _run(optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3)),
                 topt.chain(topt.clip_by_global_norm(1.0), topt.adam(1e-3)), grad_scale=grad_scale)
    _assert_updates_match(steps)
    clip = topt.clip_by_global_norm(1.0)
    g = {k: torch.full(s, grad_scale) for k, s in SHAPES.items()}
    norm = float(torch.sqrt(sum((t**2).sum() for t in g.values())))
    out, _ = clip.update({k: t.clone() for k, t in g.items()}, clip.init(g))
    got = float(torch.sqrt(sum((t**2).sum() for t in out.values())))
    assert (norm > 1.0) == clipped
    np.testing.assert_allclose(got, 1.0 if clipped else norm, rtol=1e-6)


def test_multi_steps_k2_matches_with_mini_step():
    """Updates on every 2nd call only (the mean of the two gradients), the
    others exactly zero; mini_step cycles 1, 0, 1, 0, 1."""
    jtx = optax.MultiSteps(optax.adam(1e-3), every_k_schedule=2)
    ttx = topt.multi_steps(topt.adam(1e-3), every_k_schedule=2)
    steps = _run(jtx, ttx)
    _assert_updates_match(steps)
    assert [topt.mini_step_of(s) for _, _, s in steps] == [1, 0, 1, 0, 1]
    assert all(not np.any(v) for v in steps[0][1].values())
    jstate = jtx.init(_tree({k: np.zeros(s, np.float32) for k, s in SHAPES.items()}))
    assert int(jopt.mini_step_of(jstate)) == 0 and topt.mini_step_of(ttx.init({"w": torch.zeros(2)})) == 0
    assert topt.mini_step_of(topt.adam(1e-3).init({"w": torch.zeros(2)})) is None


@pytest.mark.parametrize(
    "name,make",
    [
        ("constant", lambda o: o.constant_schedule(3e-4)),
        ("linear", lambda o: o.linear_schedule(0.0, 1e-3, 7)),
        ("linear_begin", lambda o: o.linear_schedule(1e-3, 1e-5, 5, transition_begin=3)),
        ("cosine", lambda o: o.cosine_decay_schedule(1e-3, 9, alpha=0.1)),
        ("warmup_cosine", lambda o: o.warmup_cosine_decay_schedule(0.0, 1e-3, 4, 20, 1e-4)),
    ],
)
def test_schedules_match(name, make):
    js, ts = make(optax), make(topt)
    for count in range(25):
        np.testing.assert_allclose(ts(count), float(js(count)), rtol=1e-6, atol=1e-12, err_msg=f"{name} {count}")


@pytest.mark.parametrize(
    "cfg",
    [
        dict(),
        dict(weight_decay=0.1, warmup_steps=2, total_steps=5, grad_clip=0.5),
        dict(warmup_steps=3, grad_clip=None, grad_accum_steps=2),
    ],
)
def test_make_optimizer_matches(cfg):
    jcfg, tcfg = jopt.OptimizerConfig(**cfg), topt.OptimizerConfig(**cfg)
    params = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    jtx = jopt.make_optimizer(jcfg, _tree(params))
    ttx = topt.make_optimizer(tcfg, {k.replace("/", "."): torch.from_numpy(a) for k, a in params.items()})
    _assert_updates_match(_run(jtx, ttx))


def test_weight_decay_mask_picks_the_same_leaves():
    """On a whole trunk: the JAX rule on flax paths and the port's rule on
    its parameter names decay the same tensors (embeddings and dense
    kernels; not biases or norm scales)."""
    jcfg, tcfg = jtiny(tie_word_embeddings=False), ttiny(tie_word_embeddings=False)
    jparams = init_params(jcfg, jax.random.PRNGKey(0))
    jmask = jax.tree.map(lambda m: np.full((1, 1), float(m), np.float32), jopt.weight_decay_mask(jparams))
    # the converter names and transposes leaves; masks are (1, 1) so shapes survive
    ref = {k: bool(v.reshape(-1)[0]) for k, v in params_from_jax(jmask, tcfg).items()}
    got = topt.weight_decay_mask(Transformer(tcfg, device="cpu"))
    assert got == ref
    assert got["wte.weight"] and got["h.0.attn.qkv.weight"] and not got["h.0.ln_1.weight"] and not got["h.0.mlp.fc.bias"]


def test_train_state_counts_every_call_and_updates_in_place():
    model = torch.nn.Linear(3, 2)
    ts = topt.TrainState(model, topt.adam(0.1))
    w0 = model.weight.detach().clone()
    for _ in range(3):
        ts.apply_gradients({n: torch.ones_like(p) for n, p in model.named_parameters()})
    assert ts.step == 3 and ts.params is model
    # three Adam steps on a constant gradient: each update is exactly −lr
    np.testing.assert_allclose((model.weight.detach() - w0).numpy(), -0.3, rtol=1e-5)
