"""The port's sharded train steps against its unsharded steps, on the CPU.

Each mesh shape — (2,1,1), (1,2,1) and (1,1,2) over (dp, fsdp, mp) — runs
on two gloo ranks spawned from the test (`parallel/launch.py::run_ranks`,
a file rendezvous and a timeout per group). On them, `parallel/dryrun.py::
run_algo` builds ILQL, BC, MC, CQL and PPO from fixed seeds at the JAX dry
run's tiny config, shards every module by its rule table (FSDP2) and runs
two steps with clipping, weight decay, Polyak and hard target updates. The
same function runs unsharded in the test process.

Tolerance, as tests/test_torch_ilql.py's: losses and every log term 1e-5;
parameters after two steps 2e-6 abs + 1e-4 rel, except elements whose
unsharded step-1 gradient is at noise level (below 1e-5 of its tensor's
largest), where Adam's ≈ ±lr first update may take the other sign (the
sharded step sums the batch in another order).
"""
import numpy as np
import pytest
import torch

from lmrl_gym_torch.core import optimizer as topt
from lmrl_gym_torch.parallel.dryrun import ALGOS, run_algo, run_algos
from lmrl_gym_torch.parallel.launch import run_ranks

LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_ATOL, PARAM_RTOL = 2e-6, 1e-4
NOISE = 1e-5
MESHES = {"dp2": (2, 1, 1), "fsdp2": (1, 2, 1), "mp2": (1, 1, 2)}
_TRAINED = {"ilql": {"base": "base", "q1_head": "q1_head", "q2_head": "q2_head", "v_head": "v_head",
                     "target_base_params": "base", "q1_target_params": "q1_head", "q2_target_params": "q2_head"},
            "cql": {"base": "base", "q1_head": "q1_head", "q2_head": "q2_head", "target_base_params": "base",
                    "q1_target_params": "q1_head", "q2_target_params": "q2_head"},
            "bc": {"model": "model"}, "mc": {"base": "base", "q_head": "q_head"},
            "ppo": {"policy": "policy", "value_head": "value_head"}}


def unsharded_run(algo, **kw):
    """run_algo(algo, **kw) in this process, with its step-1 gradients."""
    first = {}
    orig = topt.TrainState.apply_gradients

    def record(self, grads):
        first.setdefault(id(self), {k: g.detach().clone() for k, g in grads.items()})
        return orig(self, grads)

    topt.TrainState.apply_gradients = record
    try:
        res = run_algo(algo, **kw)
    finally:
        topt.TrainState.apply_gradients = orig
    res["grads"] = list(first.values())
    return res


def _noise_masks(algo, res):
    """module field → {param: bool mask of noise-level step-1 gradients}."""
    order = [f for f in res["params"] if f in _TRAINED[algo] and _TRAINED[algo][f] == f]
    grads = dict(zip(order, res["grads"]))
    return {f: {k: (g.abs() <= NOISE * g.abs().max()).numpy() for k, g in grads[src].items()}
            for f, src in _TRAINED[algo].items()}


def assert_run_close(got, ref, algo, label):
    """Losses and logs at LOSS_TOL, parameters at PARAM_ATOL/PARAM_RTOL
    outside the noise-level elements."""
    np.testing.assert_allclose(got["losses"], ref["losses"], **LOSS_TOL)
    assert set(got["logs"]) == set(ref["logs"])
    for k in ref["logs"]:
        np.testing.assert_allclose(got["logs"][k], ref["logs"][k], err_msg=k, **LOSS_TOL)
    noise = _noise_masks(algo, ref)
    assert set(got["params"]) == set(ref["params"])
    for field, params in ref["params"].items():
        for k, b in params.items():
            a, b = got["params"][field][k].numpy(), b.numpy()
            apart = np.abs(a - b) > PARAM_ATOL + PARAM_RTOL * np.abs(b)
            assert not (apart & ~noise[field][k]).any(), f"{label} {algo} {field}.{k}: max {np.abs(a - b).max()}"


@pytest.fixture(scope="module")
def unsharded():
    return {algo: unsharded_run(algo) for algo in ALGOS}


@pytest.fixture(scope="module", params=list(MESHES))
def sharded(request):
    return request.param, run_ranks(run_algos, 2, (ALGOS, MESHES[request.param]))[0]


@pytest.mark.parametrize("algo", ALGOS)
def test_sharded_step_matches_unsharded(sharded, unsharded, algo):
    mesh, results = sharded
    assert_run_close(results[algo], unsharded[algo], algo, mesh)
