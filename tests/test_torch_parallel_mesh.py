"""The port's mesh and partition rules (`lmrl_gym_torch/parallel/mesh.py`)
against the JAX package's (`lmrl_gym_tpu/parallel/mesh.py`) on the CPU.

- `load_mesh`: the -1 remainder axis, in one process (no group: one rank)
  and on 4 gloo ranks.
- The four rule tables: every port parameter's spec equals the spec the
  JAX table gives its flax path, reversed for a kernel (the port's
  `nn.Linear` weight is the flax kernel transposed).
- `refine_specs_for_shapes` on a (1, 3, 2) mesh, where some dims do not
  divide: the same specs as JAX's on six virtual devices.
- `shard_pytree` and `host_local_device_put` round trips at 2 and 4 ranks:
  the parameters gathered whole are the unsharded ones, bit for bit; a
  batch put on the mesh and constrained to `Spec()` is replicated whole
  (`with_sharding_constraint`, `fully_replicated`), and a no-op without a
  distributed mesh.
- `tree_size_bytes` equals JAX's.
"""
import jax
import numpy as np
import pytest
import torch

from lmrl_gym_tpu.models import encdec as jencdec
from lmrl_gym_tpu.models import heads as jheads
from lmrl_gym_tpu.models.config import tiny_test_config as jtiny
from lmrl_gym_tpu.models.transformer import init_params
from lmrl_gym_tpu.parallel import mesh as jmesh
from lmrl_gym_torch.models import encdec as tencdec
from lmrl_gym_torch.models import heads as theads
from lmrl_gym_torch.models.config import tiny_test_config as ttiny
from lmrl_gym_torch.models.transformer import Transformer
from lmrl_gym_torch.parallel import mesh as tmesh
from lmrl_gym_torch.parallel.dryrun import mesh_round_trip
from lmrl_gym_torch.parallel.launch import run_ranks

TRUNK_VARIANTS = {"tied": {}, "untied_gated": dict(tie_word_embeddings=False, gated_mlp=True)}
HEADS = {"linear": dict(input_dim=64, output_dim=1), "mlp": dict(input_dim=64, hidden_dim=128, output_dim=320)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _pairs(kind, variant):
    """(JAX params, JAX rules, port module)."""
    key = jax.random.PRNGKey(0)
    if kind == "trunk":
        kw = TRUNK_VARIANTS[variant]
        return init_params(jtiny(**kw), key), jtiny(**kw).partition_rules(), Transformer(ttiny(**kw), "cpu")
    if kind == "head":
        cls = "Linear" if variant == "linear" else "MLP"
        jcfg = getattr(jheads, f"{cls}HeadConfig")(**HEADS[variant])
        jp = jheads.init_head_params(getattr(jheads, f"{cls}Head")(jcfg), 64, key)
        tcfg = getattr(theads, f"{cls}HeadConfig")(**HEADS[variant])
        return jp, jcfg.partition_rules(), getattr(theads, f"{cls}Head")(tcfg, "cpu")
    jcfg, tcfg = jencdec.tiny_encdec_config(), tencdec.tiny_encdec_config()
    return jencdec.init_encdec_params(jcfg, key), jcfg.partition_rules(), tencdec.init_encdec_params(tcfg,
                                                                                                     device="cpu")


CASES = [("trunk", "tied"), ("trunk", "untied_gated"), ("head", "linear"), ("head", "mlp"), ("t5", "tiny")]


@pytest.mark.parametrize("kind,variant", CASES, ids=lambda x: x)
def test_rule_tables_match_jax(kind, variant):
    jparams, jrules, module = _pairs(kind, variant)
    jspecs = {k.removeprefix("params/"): tuple(v) for k, v in
              _flat(jmesh.match_partition_rules(jrules, jparams)).items()}
    tspecs = tmesh.match_partition_rules(module.config.partition_rules(), module)
    assert len(tspecs) == len(jspecs)
    for name, spec in tspecs.items():
        path, transposed = tmesh.flax_path(module, name)
        want = jspecs[path]
        ndim = module.get_parameter(name).ndim
        if transposed:
            want = tuple(reversed(want + (None,) * (ndim - len(want))))
        assert tuple(spec) == want, (name, path, spec, want)


@pytest.mark.parametrize("kind,variant", CASES, ids=lambda x: x)
def test_refine_specs_for_shapes_matches_jax(kind, variant):
    jparams, jrules, module = _pairs(kind, variant)
    jm = jmesh.load_mesh((1, 3, 2), devices=jax.devices()[:6])
    jrefined = _flat(jmesh.refine_specs_for_shapes(jmesh.match_partition_rules(jrules, jparams), jparams, jm))
    jrefined = {k.removeprefix("params/"): tuple(v) for k, v in jrefined.items()}
    tm = tmesh.Mesh(dict(dp=1, fsdp=3, mp=2), torch.device("cpu"))
    trefined = tmesh.refine_specs_for_shapes(tmesh.match_partition_rules(module.config.partition_rules(), module),
                                             module, tm)
    for name, spec in trefined.items():
        path, transposed = tmesh.flax_path(module, name)
        want = jrefined[path]
        assert tuple(spec) == (tuple(reversed(want)) if transposed else want), (name, spec, want)


@pytest.mark.parametrize("kind,variant", CASES, ids=lambda x: x)
def test_tree_size_bytes_matches_jax(kind, variant):
    jparams, _, module = _pairs(kind, variant)
    assert tmesh.tree_size_bytes(module) == jmesh.tree_size_bytes(jparams)


def test_load_mesh_one_process():
    mesh = tmesh.load_mesh((1, -1, 1), device="cpu")
    assert mesh.shape == dict(dp=1, fsdp=1, mp=1) and not mesh.is_distributed
    x = torch.arange(6).reshape(2, 3)
    assert tmesh.local_batch(x, mesh) is x
    assert tmesh.gather_batch(mesh, x)[0] is x
    assert tmesh.with_sharding_constraint(x, mesh, tmesh.batch_spec(1)) is x
    assert tmesh.with_sharding_constraint(x, None, tmesh.batch_spec(1)) is x
    with pytest.raises(ValueError):
        tmesh.load_mesh((2, 1, 1), device="cpu")
    module = Transformer(ttiny(), "cpu")
    assert tmesh.shard_module(module, mesh) is module and not tmesh.is_sharded(module)


@pytest.mark.parametrize("shape,axes,world", [
    ((2, -1, 1), tmesh.MESH_AXES, 2),
    ((1, -1, 2), tmesh.MESH_AXES, 4),
    ((2, -1, 1, 1), tmesh.MESH_AXES_SP, 4),
], ids=["dp2", "fsdp2_mp2", "dp2_fsdp2_sp"])
def test_shard_and_put_round_trip(shape, axes, world):
    out = run_ranks(mesh_round_trip, world, (shape, axes))
    sizes = dict(zip(axes, shape))
    known = int(np.prod([s for s in shape if s != -1]))
    sizes = {a: (world // known if s == -1 else s) for a, s in sizes.items()}
    for r, res in enumerate(out):
        assert res["shape"] == sizes
        assert dict(zip(axes, np.unravel_index(r, tuple(sizes.values())))) == res["coords"]
        assert res["sharded"] and res["params_equal"] and res["batch_equal"] and res["constrained"]
        assert res["batch_local"] == (8 // (sizes["dp"] * sizes["fsdp"]), 3)
    # the storage of a rank is its share over fsdp×mp of each sharded dim
    n = sizes["fsdp"] * sizes["mp"]
    assert out[0]["local_sizes"]["h.0.attn.qkv.weight"] in ((3 * 64 // n, 64), (3 * 64, 64 // n))
