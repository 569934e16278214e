"""The port's ring attention (`lmrl_gym_torch/parallel/ring_attention.py`)
against the JAX package's `make_ring_attention` on the CPU's virtual
8-device mesh, and the ring inside the trunk and a train step.

The port runs on gloo ranks spawned from the test (one per sp shard). The
cases are tests/test_ring_attention.py's at its tolerances: causal with a
padding bias (1e-5), non-causal without a bias (1e-5), and the gradients of
sum(out²) for q, k and v (1e-4), at sp 2 and 4 on the same numpy inputs.
Then tests/test_ring_integration.py's: the trunk's sp=2 logits on a
left-padded 1,024-token window against its single-device logits at 2e-4,
and a BC step with sp=2 against the unsharded step (held as
tests/test_torch_parallel_steps.py holds the sharded steps).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrl_gym_tpu.ops.flash_attention import _NEG_BIG
from lmrl_gym_tpu.parallel.mesh import load_mesh as jload_mesh
from lmrl_gym_tpu.parallel.ring_attention import make_ring_attention as jring
from lmrl_gym_torch.models.config import tiny_test_config
from lmrl_gym_torch.models.interface import LMCore
from lmrl_gym_torch.models.transformer import Transformer
from lmrl_gym_torch.parallel import dryrun
from lmrl_gym_torch.parallel.launch import run_ranks
from lmrl_gym_torch.parallel.mesh import MESH_AXES_SP
from test_torch_parallel_steps import assert_run_close, unsharded_run


def _inputs(B, H, T, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, T, D)).astype(np.float32) for _ in range(3)]


def _jax_ring(q, k, v, bias, causal, sp):
    mesh = jload_mesh((1, 1, 1, sp), ("dp", "fsdp", "mp", "sp"), devices=jax.devices()[:sp])
    ring = jring(mesh, causal=causal)

    def loss(q, k, v):
        out = ring(q, k, v, bias)
        return jnp.sum(out ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return [np.asarray(x) for x in (out, *grads)]


CASES = ("causal_bias", "non_causal")


def _case(name, sp):
    B, H, T, D = 2, 2, 64, 16
    q, k, v = _inputs(B, H, T, D, seed=sp)
    causal = name == "causal_bias"
    bias = None
    if causal:
        bias = np.broadcast_to(np.where(np.arange(T) < T - 7, 0.0, _NEG_BIG), (B, T)).astype(np.float32).copy()
    return q, k, v, bias, causal


@pytest.fixture(scope="module", params=[2, 4], ids=lambda sp: f"sp{sp}")
def ring_runs(request):
    """Both cases on one group of sp ranks."""
    sp = request.param
    cases = {name: tuple(torch.from_numpy(x) if isinstance(x, np.ndarray) else x for x in _case(name, sp))
             for name in CASES}
    return sp, run_ranks(dryrun.ring_attention_ranks, sp, (cases, sp))[0]


@pytest.mark.parametrize("case", CASES)
def test_ring_matches_jax(ring_runs, case):
    sp, runs = ring_runs
    q, k, v, bias, causal = _case(case, sp)
    ref = _jax_ring(q, k, v, bias, causal, sp)
    got = runs[case]
    np.testing.assert_allclose(got["out"].numpy(), ref[0], atol=1e-5, rtol=1e-5)
    for name, r in zip(("dq", "dk", "dv"), ref[1:]):
        np.testing.assert_allclose(got[name].numpy(), r, atol=1e-4, rtol=1e-4, err_msg=name)


def _config(**kw):
    return tiny_test_config(**{**dict(hidden_size=64, num_layers=2, num_heads=4, max_position_embeddings=1024), **kw})


def test_sp2_logits_match_single_device():
    T = 1024
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 250, (2, T)).astype(np.int64)
    ids[0, : T // 3] = dryrun.PAD  # left padding on one row
    ids = torch.from_numpy(ids)
    ref, _ = LMCore(_config(), "cpu").forward(Transformer(_config(), "cpu", seed=0), ids, pad_token_id=dryrun.PAD)
    got = run_ranks(dryrun.sp_logits_ranks, 4, (_config(sequence_parallel=True), ids, (1, 2, 1, 2)))[0]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-4, rtol=2e-4)


def test_bc_step_with_sp2():
    config = _config(sequence_parallel=True, max_position_embeddings=128)
    ref = unsharded_run("bc", config=config)
    got = run_ranks(dryrun.run_algo, 2, ("bc", (1, 1, 1, 2), "cpu", 2, config, MESH_AXES_SP))[0]
    assert got["losses"][1] < got["losses"][0]
    assert_run_close(got, ref, "bc", "sp2")
