"""Runs that repeat: a seeded run of the port gives the same numbers twice,
as the JAX package's does.

On the CPU: the port's chess gate and maze PPO gate at a tiny budget, each
run in two processes whose PYTHONHASHSEED differs, print the same result
JSON and the same progress lines (wall times aside); `resolve_device("cpu")`
leaves PyTorch's deterministic mode and the environment as they were,
`resolve_device("cuda")` turns the mode on and sets no cuBLAS workspace
variable. On the card (marked `cuda`, skipped
elsewhere): a 2-layer ILQL step and every variant and route of K1-K4, each
run twice, equal to the bit. This file imports no JAX, so on the card:

    python -m pytest tests/test_torch_rerun.py --noconftest -o addopts="" -q
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from lmrl_gym_torch.core.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--hidden", "64", "--layers", "2"]
CHESS_ARGS = TINY + ["--train-pool", "32", "--eval-pool", "16", "--bc-batches", "3", "--bc-bsize", "16",
                     "--ilql-batches", "4", "--ilql-bsize", "32", "--eval-every", "2"]
MAZE_PPO_ARGS = TINY + ["--n-chains", "8", "--bc-epochs", "1", "--rounds", "1", "--rollouts-per-round", "4",
                        "--eval-rollouts", "4", "--value-warmup-rounds", "0"]
# the maze PPO gate with its episodes cut to 6 moves (the env allows 100)
MAZE_PPO_MAIN = ("import functools, sys; from lmrl_gym_torch.cli import tasks; "
                 "from lmrl_gym_torch.scripts import maze_ppo_gate; "
                 "tasks.build_maze_env = functools.partial(tasks.build_maze_env, max_steps=6); "
                 "maze_ppo_gate.main(sys.argv[1:])")
GATE_TIMEOUT = 300
_SECONDS = re.compile(r"\d+(\.\d+)?\s?s\b")


def _run_twice(cmd: list) -> list:
    """`cmd` in two processes at once, PYTHONHASHSEED 1 and 2, one torch
    thread each → [(result JSON, progress lines with times blanked)] × 2."""
    procs = [subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=dict(os.environ, PYTHONHASHSEED=seed, OMP_NUM_THREADS="1", PYTHONPATH=REPO))
             for seed in ("1", "2")]
    runs = []
    for p in procs:
        out, err = p.communicate(timeout=GATE_TIMEOUT)
        assert p.returncode == 0, err[-3000:]
        lines = out.strip().splitlines()
        progress = [_SECONDS.sub("<t>", line) for line in lines[:-1] if not line.startswith("gate wall time")]
        runs.append((json.loads(lines[-1]), progress))
    return runs


@pytest.mark.parametrize("gate,cmd", [
    ("chess", [sys.executable, "-m", "lmrl_gym_torch.scripts.chess_ilql_gate", *CHESS_ARGS]),
    ("maze_ppo", [sys.executable, "-c", MAZE_PPO_MAIN, *MAZE_PPO_ARGS]),
])
def test_gate_repeats_across_processes(gate, cmd):
    (first, first_log), (second, second_log) = _run_twice(cmd)
    assert first == second, f"{gate} gate: {first} against {second}"
    assert first_log == second_log
    assert len(first_log) >= 4  # the stages' progress lines were compared


def test_resolve_device_sets_determinism_on_cuda_only(monkeypatch):
    before = (torch.are_deterministic_algorithms_enabled(), torch.utils.deterministic.fill_uninitialized_memory)
    env = dict(os.environ)
    assert resolve_device("cpu") == torch.device("cpu")
    assert (torch.are_deterministic_algorithms_enabled(), torch.utils.deterministic.fill_uninitialized_memory) == before
    assert not before[0] and dict(os.environ) == env
    # the card's branch, on this machine: the settings need no card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    try:
        assert resolve_device("cuda") == torch.device("cuda")
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.utils.deterministic.fill_uninitialized_memory
        assert os.environ.get("CUBLAS_WORKSPACE_CONFIG") == env.get("CUBLAS_WORKSPACE_CONFIG")
    finally:
        torch.use_deterministic_algorithms(before[0])
        torch.utils.deterministic.fill_uninitialized_memory = before[1]
        for name in set(os.environ) - set(env):  # PyTorch's deterministic mode names an Inductor cache dir
            del os.environ[name]


# ---------------- on the card ----------------

NEG_BIG = -0.7 * float(np.finfo(np.float32).max)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    resolve_device("cuda")


def _assert_same(first: list, second: list) -> None:
    assert len(first) == len(second)
    for i, (a, b) in enumerate(zip(first, second)):
        assert torch.equal(a, b), f"tensor {i}: max |diff| {(a.float() - b.float()).abs().max().item()}"


def _randn(*shape, dtype, gen):
    return torch.randn(*shape, device="cuda", generator=gen).to(dtype)


def _left_pad_bias(b, S, gen):
    """[b, S] left-pad bias; the last key of every row stays visible."""
    n_pad = torch.randint(0, S - 1, (b,), device="cuda", generator=gen)
    return torch.where(torch.arange(S, device="cuda")[None, :] >= n_pad[:, None], 0.0, NEG_BIG).float()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,Dh", [(torch.bfloat16, 64), (torch.bfloat16, 256), (torch.float32, 64)])
@pytest.mark.parametrize("B,H,Tq,S", [(64, 12, 10, 128), (8, 4, 160, 160)])
def test_flash_kernels_repeat(cuda, dtype, Dh, B, H, Tq, S):
    """K1 and, on square windows, K2 and K3: the tensor-core, wide (Dh 256)
    and f32 variants, two launches on the same inputs."""
    from lmrl_gym_torch.ops import flash_attention as tfa

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (_randn(B, H, T, Dh, dtype=dtype, gen=gen) for T in (Tq, S, S))
    bias = _left_pad_bias(B, S, gen)
    scale = Dh**-0.5
    _assert_same(*(list(tfa.flash_fwd(q, k, v, bias, True, scale)) for _ in range(2)))
    if Tq == S:
        out, lse = tfa.flash_fwd(q, k, v, bias, True, scale)
        dout = _randn(B, H, Tq, Dh, dtype=dtype, gen=gen)
        args = (q, k, v, bias, lse, tfa._delta(out, dout), dout, True, scale)
        _assert_same(*([tfa.flash_bwd_dq(*args), *tfa.flash_bwd_dkv(*args)] for _ in range(2)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,H,Dh", [(torch.bfloat16, 64, 12, 64), (torch.bfloat16, 16, 16, 256),
                                          (torch.bfloat16, 256, 16, 256), (torch.float32, 16, 4, 32)])
def test_decode_kernel_repeats(cuda, dtype, B, H, Dh):
    """K4 on both of its routes at Dh 256 (B·H under and over 1,024), bf16
    and f32: two launches on the same cache."""
    from lmrl_gym_torch.ops.decode_attention import decode_attention

    gen = torch.Generator(device="cuda").manual_seed(1)
    S, index = 160, 159  # the last slot: the bias keeps it visible
    q = _randn(B, H, 1, Dh, dtype=dtype, gen=gen)
    k, v = (_randn(B, H, S, Dh, dtype=dtype, gen=gen) for _ in range(2))
    bias = _left_pad_bias(B, S, gen)
    _assert_same(*([decode_attention(q, k, v, index, bias, Dh**-0.5)] for _ in range(2)))


@pytest.mark.cuda
def test_ilql_steps_repeat(cuda):
    """Three ILQL steps of a 2-layer GPT-2-small-width model (bf16
    activations, vocab 50,304, twin MLP Q heads, a V head), run twice from
    the same seeds: the same losses and parameters."""
    from lmrl_gym_torch.algos.ilql import ILQLBatch, ILQLConfig, init_ilql_state, make_ilql_train_step
    from lmrl_gym_torch.core.optimizer import adamw
    from lmrl_gym_torch.models.config import gpt2_small
    from lmrl_gym_torch.models.heads import MLPHead, MLPHeadConfig
    from lmrl_gym_torch.models.interface import LMCore
    from lmrl_gym_torch.models.transformer import init_params

    config = gpt2_small().replace(num_layers=2, pad_vocab_to_multiple=128, embd_pdrop=0.0, resid_pdrop=0.0,
                                  attn_pdrop=0.0)
    D, V = config.hidden_size, config.padded_vocab_size
    g = torch.Generator().manual_seed(0)
    b, t = 8, 64
    sta = torch.zeros(b, t - 1, dtype=torch.bool)
    sta[:, 1::2] = True
    batch = ILQLBatch(torch.randint(1, 256, (b, t), generator=g), sta, -1.0 * sta.float(),
                      torch.zeros(b, dtype=torch.bool), torch.randint(1, 256, (b, 16), generator=g),
                      torch.ones(b, dtype=torch.bool))
    batch = ILQLBatch(*(x.cuda() for x in batch))

    def run():
        heads = [MLPHead(MLPHeadConfig(D, 2 * D, out, layer2_initializer_range=None), device="cuda", seed=s)
                 for s, out in ((1, V), (2, V), (3, 1))]
        modules = (init_params(config, seed=0, device="cuda"), *heads)
        state = init_ilql_state(*modules, adamw(1e-4), adamw(1e-3), ILQLConfig())
        step = make_ilql_train_step(LMCore(config), ILQLConfig(), 50256)
        losses = []
        for _ in range(3):
            state, loss, _ = step(state, batch)
            losses.append(loss.reshape(1))
        return [torch.cat(losses)] + [p.detach().clone() for m in modules for p in m.parameters()]

    _assert_same(run(), run())
