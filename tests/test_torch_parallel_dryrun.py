"""`lmrl_gym_torch.parallel.dryrun.dryrun_multichip(8, "cpu")` against the
JAX package's dry run (`__graft_entry__.py::dryrun_multichip`'s ILQL step)
on the CPU's virtual 8-device mesh.

Both build the mesh (dp, fsdp, mp) = (2, 2, 2), the tiny config with
4 heads at width 64, zero-initialised MLP Q/V heads, Adam 1e-4 (base) and
1e-3 (heads), and the same numpy batch. The JAX side's initial weights go
into the port through `models/convert.py`; the port shards every module
by its rule table on eight gloo ranks and runs one step.

Tolerance, as tests/test_torch_ilql.py's: the loss and every log term
1e-5; parameters 2e-6 abs + 1e-4 rel, except elements whose step-1 JAX
gradient is at noise level (below 1e-5 of its tensor's largest).
"""
import jax
import numpy as np
import optax
import torch
from jax.sharding import NamedSharding, PartitionSpec as PS

from lmrl_gym_tpu.algos import ilql as jilql
from lmrl_gym_tpu.models.config import tiny_test_config as jtiny
from lmrl_gym_tpu.models.heads import MLPHead, MLPHeadConfig, init_head_params
from lmrl_gym_tpu.models.interface import LMCore as JCore
from lmrl_gym_tpu.models.transformer import init_params
from lmrl_gym_tpu.parallel.mesh import load_mesh, match_partition_rules, refine_specs_for_shapes, shard_pytree
from lmrl_gym_torch.models.convert import head_params_from_jax, params_from_jax
from lmrl_gym_torch.parallel.dryrun import PAD, dryrun_batch, dryrun_mesh_shape, dryrun_multichip, flat_logs

N = 8
NOISE = 1e-5


def _jax_dryrun():
    dp, fsdp, mp = dryrun_mesh_shape(N)
    mesh = load_mesh((dp, fsdp, mp), devices=jax.devices()[:N])
    config = jtiny(num_heads=4, hidden_size=64)
    key = jax.random.PRNGKey(0)
    base = init_params(config, key)
    qkw = dict(input_dim=64, hidden_dim=128, layer2_initializer_range=0.0)
    q_cfg, v_cfg = MLPHeadConfig(output_dim=config.padded_vocab_size, **qkw), MLPHeadConfig(output_dim=1, **qkw)
    q_head, v_head = MLPHead(q_cfg), MLPHead(v_cfg)
    ks = jax.random.split(key, 3)
    heads = [init_head_params(q_head, 64, ks[0]), init_head_params(q_head, 64, ks[1]),
             init_head_params(v_head, 64, ks[2])]
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    weights = {"base": params_from_jax(np_tree(base), config)}
    weights.update({k: head_params_from_jax(np_tree(h)) for k, h in zip(("q1", "q2", "v"), heads)})

    def shard(params, rules):
        return shard_pytree(params, refine_specs_for_shapes(match_partition_rules(rules, params), params, mesh), mesh)

    conf = jilql.ILQLConfig()
    state = jilql.init_ilql_state(shard(base, config.partition_rules()), shard(heads[0], q_cfg.partition_rules()),
                                  shard(heads[1], q_cfg.partition_rules()), shard(heads[2], v_cfg.partition_rules()),
                                  optax.adam(1e-4), optax.adam(1e-3), conf)
    arrays = dryrun_batch(config, max(4, dp * fsdp * 2))
    batch = jilql.ILQLBatch(**{k: jax.device_put(a.astype(np.int32) if a.dtype == np.int64 else a,
                                                 NamedSharding(mesh, PS(("dp", "fsdp"))))
                               for k, a in arrays.items()})

    def loss_fn(b, q1, q2, v):
        return jilql.ilql_forward(JCore(config), q_head, v_head, b, state.target_base_params, q1, q2, v,
                                  state.q1_target_params, state.q2_target_params, batch, conf, PAD,
                                  train=True, rng=None)

    _, grads = jax.value_and_grad(loss_fn, argnums=(0, 1, 2, 3), has_aux=True)(
        state.base.params, state.q1_head.params, state.q2_head.params, state.v_head.params)
    grads = [params_from_jax(np_tree(grads[0]), config)] + [head_params_from_jax(np_tree(g)) for g in grads[1:]]
    step = jilql.make_ilql_train_step(JCore(config, mesh=mesh), q_head, v_head, conf, pad_token_id=PAD, mesh=mesh)
    state, loss, logs = step(state, batch, jax.random.PRNGKey(1))
    final = {"base": params_from_jax(np_tree(state.base.params), config),
             "target_base_params": params_from_jax(np_tree(state.target_base_params), config)}
    for name in ("q1_head", "q2_head", "v_head"):
        final[name] = head_params_from_jax(np_tree(getattr(state, name).params))
    for name in ("q1_target_params", "q2_target_params"):
        final[name] = head_params_from_jax(np_tree(getattr(state, name)))
    return weights, grads, float(loss), flat_logs(jax.tree.map(float, logs)), final


def test_dryrun_multichip_matches_jax():
    weights, grads, jloss, jlogs, jfinal = _jax_dryrun()
    out = dryrun_multichip(N, "cpu", weights=weights)
    assert out["mesh"] == (2, 2, 2)
    assert out["sharded_modules"] == 7  # base, target base, three heads, two target heads
    np.testing.assert_allclose(out["loss"], jloss, atol=1e-5, rtol=1e-5)
    assert set(out["logs"]) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(out["logs"][k], jlogs[k], atol=1e-5, rtol=1e-5, err_msg=k)
    source = dict(base="base", target_base_params="base", q1_head="q1", q2_head="q2", v_head="v",
                  q1_target_params="q1", q2_target_params="q2")
    by_group = dict(zip(("base", "q1", "q2", "v"), grads))
    for field, ref in jfinal.items():
        g = by_group[source[field]]
        for k, b in ref.items():
            a, b = out["params"][field][k].numpy(), b.numpy()
            noise = np.abs(g[k].numpy()) <= NOISE * np.abs(g[k].numpy()).max()
            apart = np.abs(a - b) > 2e-6 + 1e-4 * np.abs(b)
            assert not (apart & ~noise).any(), f"{field}.{k}: max {np.abs(a - b).max()}"
