"""Smoke test of lmrl_gym_torch on one CUDA card (an H100; the kernels
target sm_90a).

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. the card (`nvidia-smi` name and power limit) and the kernel build
   (`nvcc`, one process per source, all started together, from
   lmrl_gym_torch/csrc/);
2. each CUDA kernel against its plain PyTorch version on the card, at the
   serving path's shapes (B=512, H=12, Dh=64) and, for the flash forward
   and backward kernels, the training shapes (B=32, H=12, T=160, Dh=64,
   with a left-padded and a right-aligned Tq < S case; the forward also at
   the next window's T=16), a ragged T=100 (and Tq=37 over S=100) and
   Dh=128 at B=4, H=32, T=160, in bf16 (the tensor-core variant of the
   forward and the backward) and f32 (their CUDA-core variant), with the
   max abs error, its tolerance (and on fully masked left-pad rows lse
   equal to the plain version's −0.7·f32max), the variant each launch
   took, and the kernel, plain and library
   (scaled_dot_product_attention, forward or backward, a yardstick the port
   never calls) times; the backward cases include the online train step's
   (B=64, H=12, T=128) and the gate's (B=512, H=4, T=128) shapes, and
   one bf16 case on right-padded windows whose pad rows keep a live
   cotangent, held against the plain version with P and dS rounded to
   bf16 (the kernels' arithmetic), its drift from the f32-P plain version
   printed;
2p. K1 and K4 against their plain versions at the later paths' shapes,
   bf16: the online rollout (B=256, H=12) and the gate's evals (B=512,
   H=4) on cache views, the text env's and LMServer's left-padded prefill
   and decode with bias (B=8 and 4, prompts of 128 and 48 tokens);
3. serving at full width: value-guided Wordle serving with GPT-2-small
   (vocab 50,257 padded to 50,304), bf16 weights from a seed, two trunks,
   twin MLP Q heads, beta=32, constrained vocab, B=512 — one warm-up and five
   timed `rollout_wordle`s, each with the kernels' launch counts (every
   flash_fwd launch the tensor-core variant) and the rollout's invariants
   checked, and one more under torch.profiler for the
   device busy time, idle share and device time by kernel category; then
   `ValueGuidedServer.generate_from_strs` answers 4 left-padded prompts;
3t. training at full width, at `bench.py::bench_ilql_real_vocab`'s
   operating point: the ILQL train step on GPT-2-small (f32 parameters,
   bf16 activations), twin MLP Q heads (hidden 1536, out 50,304) and a V
   head, a separate target base, AdamW, B=32, T=160, next window 16 — one
   warm-up and ten timed steps, each with its launch counts (36 flash_fwd,
   12 flash_bwd_dq, 12 flash_bwd_dkv, every launch the tensor-core
   variant) and a finite loss checked, then one more under
   torch.profiler; then three BC steps on the same trunk (12/12/12
   launches, the same check);
3o. on-device online ILQL at full width (`loops/online_device.py::
   online_ilql_wordle`): GPT-2-small with f32 parameters and bf16
   activations, twin MLP Q heads and a V head, a separate target base,
   AdamW, beta=32, `OnlineDeviceConfig()` (4 rounds of a B=256 one-trunk
   guided rollout on the live modules, then four B=64, T=128 train steps):
   per round the rollout's launches (84 flash_fwd, 720 decode_attn) and
   each step's (24 / 12 / 12), all on the tensor-core variants, the
   rollout's invariants, a finite loss, base weights that move between
   rounds, the rollout and train wall time per round and the peak memory;
   then the rollout and the round's train steps once more, each under
   torch.profiler;
3g. the port's Wordle ILQL gate (`lmrl_gym_torch/scripts/
   wordle_ilql_gate.py`) at its own width (d256, L4, H4, byte vocab 259
   padded to 320) and a cut budget (100 BC, 100 %BC, 100 ILQL steps, eval
   batch 512, no OptimalPolicy bound): every stage runs, its launch counts
   are the budget's, and every return is finite and in [-6, 0];
3s. legal-set and text-env serving on the phase-3 weights: a
   `GenerationPolicy` over `ValueGuidedServer.generate_from_strs_legal`
   (the 400 vocab words as proposals) plays 8 `ReformatWordleEnv` games
   through `envs/base.py`'s interaction loop — every action a vocab word,
   every game over within 6 turns, 24 flash_fwd (left-padded, with bias)
   and 240 decode_attn launches per turn; then `LMServer.generate_from_strs`
   answers 4 prompts;
3m. the MC-returns train step at phase 3t's operating point (one MLP Q
   head): one warm-up, five timed steps with exact launch counts (12 / 12 /
   12, tensor cores) and finite losses, one profiled step; then one
   full-width f32 step on the card against the CPU (as phase 4's ILQL
   step);
3c. the CQL train step at the same point with a separate target base and
   a next window of 16 (36 / 12 / 12 per step), the same checks, its peak
   memory;
3p. one PPO round on the maze (`build_maze_env`, byte tokenizer, episodes
   cut to 8 moves) at GPT-2-small width over the byte vocab: 32 episodes
   at batch 16 through `GenerationPolicy` → `LMServer` → `text_env_eval`
   (12 K1 and 144 K4 launches per call), `get_ppo_data_from_chains`
   through `make_ppo_forward_fn` (24 K1 per call, finite KL and values),
   `block_ppo_data`, then two PPO steps at B=32 without the BC term (12 /
   12 / 12) and two with it (24 / 24 / 24), finite losses, moving weights;
3r. `ReRankerPolicy` over the maze's four move proposals in all 25 cells,
   scored at the same width by `make_ilql_score_fn` (twin Q and V: 12 K1
   per score call; with a π_β trunk and `logit_weight`: 24) and
   `make_mc_score_fn` (12): every action one of the proposals;
3z. the port's maze gate (`lmrl_gym_torch/scripts/maze_ilql_gate.py`) at
   its own width (d256 L4 H4, byte vocab) and a cut budget (50 chains, one
   BC epoch, two value epochs, legal-move guided decode), --algo cql then
   --algo mc: launch counts exactly the budget's, accuracies in [0, 1];
4. the same full-width serving weights at B=4 on the card (kernels, bf16)
   against the CPU (plain path, f32): header prefill plus 3 decode steps;
   and one full-width ILQL step (f32, B=2, T=32) on the card against the
   CPU: loss within 1e-4 relative, each parameter group's gradient within
   1e-3 in relative norm, no launch on the tensor-core variant;
5. a `{"kernels": [...]}` line: per kernel its launches on its path (per
   rollout, or per train step) and its mean time per launch over that
   path's shapes beside the bound (bytes or FLOPs at the H100's published
   peaks), the plain version's and the library call's; for flash_fwd also
   the CUDA-core variant's time on the same shapes (`simt_ms`), the
   kernel the tensor-core one replaced there. flash_fwd runs on
   both paths: its main keys are the rollout's, and the `*_train_step`
   keys the same numbers for one ILQL train step; `launches_<path>` are
   the counts recorded on each later path (the online round and step, the
   Wordle gate, a text-env turn, an MC, CQL and PPO step, a PPO forward
   call and rollout turn, a score call, the cut maze gates). Every kernel with two
   variants carries the `variant` its main path runs and its `tc_launches`; and beside SDPA's backward
   (`library_ms`, which computes its own rowsum(dO ⊙ O)) the port's Δ pass
   (`delta_ms`) and the pair plus Δ (`pair_plus_delta_ms`).

The last line is `{"ok": true, "device": {...}}`. Without a CUDA device the
script exits 2 and prints no result.
"""
from __future__ import annotations

import contextlib
import copy
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from lmrl_gym_torch.algos.bc import BCBatch, BCConfig, BCTrainState, make_bc_train_step
from lmrl_gym_torch.algos.cql import CQLConfig, cql_forward, init_cql_state, make_cql_train_step
from lmrl_gym_torch.algos.ilql import (
    ILQLBatch,
    ILQLConfig,
    ilql_loss_and_grads,
    init_ilql_state,
    make_ilql_train_step,
)
from lmrl_gym_torch.algos.mc import MCBatch, MCConfig, MCTrainState, make_mc_train_step, mc_loss_from_params
from lmrl_gym_torch.algos.ppo import (
    PPOBatch,
    PPOConfig,
    PPOTrainState,
    block_ppo_data,
    get_ppo_data_from_chains,
    make_ppo_forward_fn,
    make_ppo_train_step,
)
from lmrl_gym_torch.algos.value_policy import (
    GenerationPolicy,
    LMServer,
    ReRankerPolicy,
    ValueGuidedServer,
    ValueRLParams,
    make_ilql_score_fn,
    make_mc_score_fn,
    tokenize_histories_for_scoring,
)
from lmrl_gym_torch.cli.tasks import build_maze_env, generate_maze_chains
from lmrl_gym_torch.core.blocking import BlockingStrategy, Padding, Truncation
from lmrl_gym_torch.core.optimizer import TrainState, adamw, value_and_grads
from lmrl_gym_torch.envs.base import text_env_eval
from lmrl_gym_torch.envs.maze.eval import per_cell_optimal_move_accuracy
from lmrl_gym_torch.envs.maze.grids import ACTION_STRS, double_t_maze
from lmrl_gym_torch.envs.wordle.env import ReformatWordleEnv, WordleEnv
from lmrl_gym_torch.envs.wordle.vector import N_TRIES, WordleVectorEnv, WordleVocab
from lmrl_gym_torch.loops import actor, online_device
from lmrl_gym_torch.loops.online_device import OnlineDeviceConfig, online_ilql_wordle, wordle_rollout_to_ilql_batch
from lmrl_gym_torch.models.config import gpt2_small
from lmrl_gym_torch.models.generation import SamplingConfig
from lmrl_gym_torch.models.heads import LinearHead, LinearHeadConfig, MLPHead, MLPHeadConfig
from lmrl_gym_torch.models.interface import LMCore
from lmrl_gym_torch.models.transformer import Transformer, init_params
from lmrl_gym_torch.ops import _build
from lmrl_gym_torch.ops import flash_attention as flash_module
from lmrl_gym_torch.ops.decode_attention import _plain_decode_attention, decode_attention
from lmrl_gym_torch.ops.flash_attention import (
    _NEG_BIG,
    _delta,
    _plain_attention,
    _plain_bwd_dkv,
    _plain_bwd_dq,
    _plain_dscores,
    _variant,
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_fwd,
)
from lmrl_gym_torch.scripts import maze_ilql_gate, wordle_ilql_gate
from lmrl_gym_torch.text.frames import (
    Text,
    TextTrajectory,
    TextTrajectoryChain,
    TokenTrajectoryChain,
    text_history_to_str,
)
from lmrl_gym_torch.text.tokenizer import ByteTokenizer

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

B, H, DH, T_MAX = 512, 12, 64, actor.EPISODE_LEN
# kernel vs plain: |kernel − plain| ≤ atol + rtol·|plain|. f32: summation
# order only. bf16: two bf16 ulps, since both round the output (and the
# plain version its probabilities) to bf16.
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-2, 2.0**-6)}
# backward kernels vs plain: f32 adds 1e-5 relative (dK sums up to 160
# query rows); bf16 as the forward
GRAD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 2.0**-6)}
# card (bf16 weights/activations, kernels) vs CPU (f32, plain path) logits
# after 12 layers: bf16 keeps ~3 significant digits per op, logits ~ ±3
LOGIT_TOL = 0.1
ROLLOUT_REPS = 5  # timed rollouts; the median is reported beside min and max
SPIN_CYCLES = 10_000_000  # cuda_ms's head start for the host: ~5 ms at the H100's 1.98 GHz boost
# training: bench.py::bench_ilql_real_vocab's operating point
TRAIN_B, TRAIN_T, NEXT_T = 32, 160, 16
TRAIN_REPS = 10
PAD_ID = 50256  # as bench.py passes it (no batch token is a pad)
# card vs CPU ILQL step in f32 at full width: TF32 is off, so only the
# summation order differs (~1e-6 relative per op)
STEP_LOSS_RTOL, STEP_GRAD_RTOL = 1e-4, 1e-3
# the maze paths: windows and prompts blocked to 160 tokens (the maze
# gate's MAX_LEN), 12 new tokens per action
MAZE_LEN, MAZE_NEW = 160, 12


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean ms per call over `reps` back-to-back calls, by CUDA events. A
    spin kernel (~5 ms) runs first, so the host has queued the calls
    before the device reaches them: a call whose host work outlasts its
    kernels (a wrapper around a 20 µs kernel) is timed by its kernels."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20) -> float:
    """Mean device time per call: the sum of the device times of the
    kernels `reps` calls launch, under torch.profiler. For calls whose host
    work outlasts their device work (autograd around a small library
    kernel), where CUDA events would time the host."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    check(total > 0, "the profiler recorded no device time")
    return total / reps


def excess(out, ref, dtype):
    """Elementwise |out − ref| − rtol·|ref|, to hold against atol."""
    return (out.float() - ref.float()).abs() - TOL[dtype][1] * ref.float().abs()


def bound_ms(n_bytes: float, flops: float, dtype) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else "operations")


def flash_work(Tq: int, S: int, dtype) -> tuple:
    """Bytes (each input read once, each output written once) and FLOPs of
    one causal flash forward without bias: QKᵀ and PV over the visible
    (query, key) pairs."""
    es = torch.finfo(dtype).bits // 8
    n_bytes = es * B * H * DH * (2 * Tq + 2 * S) + 4 * B * H * Tq
    pairs = sum(S - Tq + i + 1 for i in range(Tq))
    return n_bytes, 4.0 * B * H * DH * pairs


def decode_work(n_keys: int, dtype) -> tuple:
    """Bytes and FLOPs of one decode step over n_keys cache slots, no bias."""
    es = torch.finfo(dtype).bits // 8
    n_bytes = es * B * H * DH * (2 + 2 * n_keys)
    return n_bytes, 4.0 * B * H * DH * n_keys


def bwd_work(b: int, Tq: int, S: int, dtype, kernel: str, with_bias: bool) -> tuple:
    """Bytes and FLOPs of one backward kernel over the causal (query, key)
    pairs. Both read q, k, v, dO, lse and Δ (and the bias when given); K2
    writes dQ and does QKᵀ, dO·Vᵀ and dS·K (6·Dh FLOPs per pair), K3 writes
    dK and dV and adds Pᵀ·dO and dSᵀ·Q (8·Dh per pair)."""
    es = torch.finfo(dtype).bits // 8
    n_q, n_kv = b * H * Tq * DH, b * H * S * DH
    n_bytes = es * (2 * n_q + 2 * n_kv) + 4 * 2 * b * H * Tq + (4 * b * S if with_bias else 0)
    n_bytes += es * (n_q if kernel == "dq" else 2 * n_kv)
    pairs = b * H * sum(S - Tq + i + 1 for i in range(Tq))
    return n_bytes, (6.0 if kernel == "dq" else 8.0) * DH * pairs


@contextlib.contextmanager
def forced_variant(variant: str):
    """K1-K3 launch `variant` whatever `_variant` picks: times the
    CUDA-core forward that the tensor-core one replaced on the main paths,
    in the same run and on the same inputs."""
    picked = flash_module._variant
    flash_module._variant = lambda dtype, head_dim: variant
    try:
        yield
    finally:
        flash_module._variant = picked


def sdpa_mask(bias, Tq: int, S: int, b: int = B):
    """Boolean [b,1,Tq,S] mask (True = attend) for the library yardstick."""
    q_pos = torch.arange(Tq, device="cuda") + (S - Tq)
    mask = (q_pos[:, None] >= torch.arange(S, device="cuda")[None, :])[None, None]
    if bias is not None:
        mask = mask & (bias == 0)[:, None, None, :]
    return mask.expand(b, 1, Tq, S)


def sdpa_bwd_ms(q, k, v, bias, dout, scale: float, causal_only: bool) -> float:
    """The library yardstick for K2 + K3 together: scaled_dot_product_attention's
    backward, timed as device time of (forward + backward) − forward."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    Tq, S = q.shape[2], k.shape[2]
    kw = dict(is_causal=True) if causal_only else dict(attn_mask=sdpa_mask(bias, Tq, S, q.shape[0]))
    with torch.enable_grad():
        t_fb = device_ms(lambda: torch.autograd.grad(sdpa(qs, ks, vs, scale=scale, **kw), (qs, ks, vs), dout))
        t_f = device_ms(lambda: sdpa(qs, ks, vs, scale=scale, **kw))
    return t_fb - t_f


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    reports = _build.build_all(["flash_fwd", "flash_fwd_tc", "flash_bwd", "flash_bwd_tc", "decode_attn"])
    log(f"kernel build: {time.perf_counter() - t0:.2f} s for {sorted(reports) or 'nothing (cached)'}")
    for name, report in sorted(reports.items()):
        for line in report.splitlines():
            if "Compiling entry function" in line:
                log(f"  ptxas {name}: {line.split(chr(39))[1][:110]}")  # the mangled kernel name
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {name}:   {line.strip()}")
    return card


def _flash_inputs(Tq, S, dtype, padded, gen, b=B, h=H, t_max=None):
    """q [b,h,Tq,DH], k/v [b,h,S,DH] and a left-pad bias [b,S]; with
    `t_max`, as the cached trunk passes them: q a view into the fused
    [b,Tq,3·h·DH] projection, k/v the filled prefix of a [b,h,t_max,DH]
    cache and the bias the prefix of a [b,t_max] one."""
    if t_max is None:
        q = torch.randn(b, h, Tq, DH, device="cuda", generator=gen).to(dtype)
    else:
        q = torch.randn(b, Tq, 3, h, DH, device="cuda", generator=gen).to(dtype)[:, :, 0].transpose(1, 2)
    k = torch.randn(b, h, t_max or S, DH, device="cuda", generator=gen).to(dtype)[:, :, :S]
    v = torch.randn(b, h, t_max or S, DH, device="cuda", generator=gen).to(dtype)[:, :, :S]
    bias = None
    if padded:
        n_pad = torch.randint(0, S, (b,), device="cuda", generator=gen)
        pos = torch.arange(t_max or S, device="cuda")[None, :]
        bias = torch.where(pos >= n_pad[:, None], 0.0, _NEG_BIG).float()[:, :S]
    return q, k, v, bias


def _decode_inputs(index, dtype, padded, gen, b=B, h=H, t_max=T_MAX, max_pad=None):
    q = torch.randn(b, h, 1, DH, device="cuda", generator=gen).to(dtype)
    k = torch.randn(b, h, t_max, DH, device="cuda", generator=gen).to(dtype)
    v = torch.randn(b, h, t_max, DH, device="cuda", generator=gen).to(dtype)
    bias = None
    if padded:  # key `index` stays visible
        n_pad = torch.randint(0, min(index, max_pad or index) + 1, (b,), device="cuda", generator=gen)
        bias = torch.where(torch.arange(t_max, device="cuda")[None, :] >= n_pad[:, None], 0.0, _NEG_BIG).float()
    return q, k, v, bias


def _check_decode(q, k, v, index, bias, dtype, label: str) -> float:
    """decode_attention against _plain_decode_attention within TOL; returns
    the max abs error."""
    scale = 1.0 / q.shape[-1]**0.5
    out = decode_attention(q, k, v, index, bias, scale)
    ref = _plain_decode_attention(q, k, v, index, bias, scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    check(excess(out, ref, dtype).max().item() <= TOL[dtype][0], f"decode_attn {label} {dtype}: max abs err {err}")
    return err


def _check_fwd(q, k, v, bias, rows, dtype, label: str) -> tuple:
    """flash_fwd against _plain_attention on the same inputs: out within
    TOL and lse within 1e-3 on the query rows that see a key (`rows`,
    [b, Tq]; the outputs of fully padded rows hold garbage in both), lse of
    the fully padded rows equal to the plain version's (−0.7·f32max, which
    the backward reads as P = 1), and the launch on the variant `_variant`
    picks. Returns (max abs error of out, of lse)."""
    scale = 1.0 / q.shape[-1]**0.5
    tc0 = flash_fwd.tc_launches
    out, lse = flash_fwd(q, k, v, bias, True, scale)
    n_tc = flash_fwd.tc_launches - tc0
    want_tc = int(_variant(dtype, q.shape[-1]) == "tc")
    check(n_tc == want_tc, f"flash_fwd {label} {dtype}: tensor-core launches {n_tc}, want {want_tc}")
    ref, ref_lse = _plain_attention(q, k, v, bias, True, scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().amax(dim=(1, 3))[rows].max().item()
    over = excess(out, ref, dtype).amax(dim=(1, 3))[rows].max().item()
    lse_err = (lse - ref_lse).abs()[rows[:, None, :].expand_as(lse)].max().item()
    check(over <= TOL[dtype][0], f"flash_fwd {label} {dtype}: max abs err {err} over tolerance {TOL[dtype]}")
    check(lse_err <= 1e-3, f"flash_fwd {label} {dtype}: lse err {lse_err}")
    dead = (~rows)[:, None, :].expand_as(lse)
    check(bool(torch.isfinite(lse).all() and torch.equal(lse[dead], ref_lse[dead]) and (lse[dead] == _NEG_BIG).all()),
          f"flash_fwd {label} {dtype}: lse of fully padded rows differs from the plain version's")
    return err, lse_err


def phase_kernel_checks() -> dict:
    """Kernel vs plain on the card; returns {kernel: max abs error}."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    scale = 1.0 / DH**0.5
    errs = {"flash_fwd": 0.0, "decode_attn": 0.0}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dtype in (torch.bfloat16, torch.float32):
        for Tq, S, padded in ((8, 8, False), (10, 128, False), (64, 64, True)):
            q, k, v, bias = _flash_inputs(Tq, S, dtype, padded, gen)
            rows = torch.ones(B, Tq, dtype=torch.bool, device="cuda") if bias is None else bias[:, S - Tq:] == 0
            err, lse_err = _check_fwd(q, k, v, bias, rows, dtype, f"B={B} Tq={Tq} S={S}")
            errs["flash_fwd"] = max(errs["flash_fwd"], err)
            mask = sdpa_mask(bias, Tq, S)
            t_k = cuda_ms(lambda: flash_fwd(q, k, v, bias, True, scale))
            t_p = cuda_ms(lambda: _plain_attention(q, k, v, bias, True, scale))
            t_l = cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=scale))
            log(f"check flash_fwd B={B} H={H} Tq={Tq} S={S} offset={S - Tq} bias={padded} {str(dtype)[6:]}: "
                f"max_abs_err={err:.3e} (atol, rtol {TOL[dtype]}) lse_err={lse_err:.3e} "
                f"kernel_ms={t_k:.4f} plain_ms={t_p:.4f} library_ms={t_l:.4f}")
        for index in (8, 67, 127):
            for padded in (False, True):
                q, k, v, bias = _decode_inputs(index, dtype, padded, gen)
                err = _check_decode(q, k, v, index, bias, dtype, f"index={index} bias={padded}")
                errs["decode_attn"] = max(errs["decode_attn"], err)
                n = index + 1
                kp, vp = k[:, :, :n], v[:, :, :n]
                mask = None if bias is None else (bias[:, :n] == 0)[:, None, None, :]
                t_k = cuda_ms(lambda: decode_attention(q, k, v, index, bias, scale))
                t_p = cuda_ms(lambda: _plain_decode_attention(q, k, v, index, bias, scale))
                t_l = cuda_ms(lambda: sdpa(q, kp, vp, attn_mask=mask, scale=scale))
                log(f"check decode_attn B={B} H={H} T_max={T_MAX} index={index} bias={padded} {str(dtype)[6:]}: "
                    f"max_abs_err={err:.3e} (atol, rtol {TOL[dtype]}) "
                    f"kernel_ms={t_k:.4f} plain_ms={t_p:.4f} library_ms={t_l:.4f}")
    return errs


def _bwd_inputs(Tq, S, dtype, padded, gen, b=TRAIN_B, h=H, dh=DH, live_pad_rows=False):
    """One backward's inputs as the trunk makes them: q/k/v views into a
    fused [b, S, 3, h, dh] projection, the forward's lse, a cotangent zero
    on fully masked (left-pad) query rows, and Δ; the [b, Tq] mask of query
    rows that see a key; and the forward's out. `padded` is False, True or
    "left" (a left-pad bias), or "right" (a right-pad bias: the blocked
    windows of the maze and PPO data). The cotangent is zero on every pad
    query row, as the trunk gives it: no real position reads a left-pad
    row (fully masked) or a right-pad row (causally after every real
    one), and the losses mask both. `live_pad_rows` keeps a random
    cotangent on them instead."""
    qkv = torch.randn(b, S, 3, h, dh, device="cuda", generator=gen).to(dtype)
    q = qkv[:, S - Tq:, 0].transpose(1, 2)
    k, v = qkv[:, :, 1].transpose(1, 2), qkv[:, :, 2].transpose(1, 2)
    bias = torch.zeros(b, S, device="cuda")
    rows = torch.ones(b, Tq, dtype=torch.bool, device="cuda")
    pos = torch.arange(S, device="cuda")[None, :]
    if padded == "right":
        n_valid = torch.randint(1, S + 1, (b,), device="cuda", generator=gen)
        bias = torch.where(pos < n_valid[:, None], 0.0, _NEG_BIG).float()
    elif padded:
        n_pad = torch.randint(0, S, (b,), device="cuda", generator=gen)
        bias = torch.where(pos >= n_pad[:, None], 0.0, _NEG_BIG).float()
        rows = bias[:, S - Tq:] == 0
    out, lse = flash_fwd(q, k, v, bias, True, 1.0 / dh**0.5)
    dout = torch.randn(b, Tq, h, dh, device="cuda", generator=gen).to(dtype).transpose(1, 2)
    if not live_pad_rows:
        dout = dout * (bias[:, S - Tq:] == 0)[:, None, :, None].to(dtype)
    return (q, k, v, bias, lse, _delta(out, dout), dout), rows, out


def _plain_bwd_rounded(q, k, v, bias, lse, delta, dout, causal: bool, scale: float):
    """The plain backward with P and dS rounded to bf16 before the products
    that take them (dV = Pᵀ·dO, dQ = dS·K, dK = dSᵀ·Q), as the tensor-core
    kernels round them as MMA operands; f32 sums → (dq, dk, dv) in bf16."""
    p, ds = _plain_dscores(q, k, v, bias, lse, delta, dout, causal, scale)
    p, ds = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dout.float())
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def _check_bwd_live_pad_rows(gen, errs: dict) -> None:
    """bf16 K2 and K3 on right-padded maze windows whose pad query rows keep
    a live cotangent (no trunk gives them one): up to 160 rows then feed the
    few keys of a short window, and the bf16 rounding of P and dS adds up
    there. Held against `_plain_bwd_rounded`, the kernels' own arithmetic;
    the drift from the plain version (P and dS in f32) is printed."""
    dtype, scale = torch.bfloat16, 1.0 / DH**0.5
    args, _, _ = _bwd_inputs(MAZE_LEN, MAZE_LEN, dtype, "right", gen, live_pad_rows=True)
    got = (flash_bwd_dq(*args, True, scale), *flash_bwd_dkv(*args, True, scale))
    rounded = _plain_bwd_rounded(*args, True, scale)
    plain = (_plain_bwd_dq(*args, True, scale), *_plain_bwd_dkv(*args, True, scale))
    torch.cuda.synchronize()
    line = []
    for name, a, r, p in zip(("dq", "dk", "dv"), got, rounded, plain):
        err = (a.float() - r.float()).abs().max().item()
        over = ((a.float() - r.float()).abs() - GRAD_TOL[dtype][1] * r.float().abs()).max().item()
        check(over <= GRAD_TOL[dtype][0], f"flash_bwd {name} live pad rows: max abs err {err} against the "
                                          f"bf16-rounded plain version, over tolerance {GRAD_TOL[dtype]}")
        kernel = "flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"
        errs[kernel] = max(errs[kernel], err)
        line.append(f"{name}_max_abs_err={err:.3e} {name}_drift_from_plain={(a.float() - p.float()).abs().max().item():.3e}")
    log(f"check flash_bwd B={TRAIN_B} H={H} Dh={DH} Tq=S={MAZE_LEN} right-padded, live pad rows, bf16, against the "
        f"bf16-rounded plain version: " + " ".join(line) + f" (atol, rtol {GRAD_TOL[dtype]})")


def _tc_counts():
    return flash_bwd_dq.tc_launches, flash_bwd_dkv.tc_launches


# phase 2's backward cases: (b, h, dh, Tq, S, padding); the training
# shapes first, then the online train step's (B=64, T=128) and the gate's
# (d256 H4: B=512, H=4, T=128), a ragged T (not a multiple of the 64-row
# tile), LLaMA's head width, and the right-padded maze windows blocked to
# 160 tokens of the PPO steps and the PPO forward (B=32, H=12) and of the
# maze gate's train steps (d256 H4: B=32, H=4)
BWD_CASES = (
    (TRAIN_B, H, DH, TRAIN_T, TRAIN_T, False), (TRAIN_B, H, DH, TRAIN_T, TRAIN_T, True),
    (TRAIN_B, H, DH, 96, TRAIN_T, False), (64, H, DH, T_MAX, T_MAX, False), (512, 4, DH, T_MAX, T_MAX, False),
    (TRAIN_B, H, DH, 100, 100, True), (TRAIN_B, H, DH, 37, 100, False), (4, 32, 128, 160, 160, True),
    (TRAIN_B, H, DH, MAZE_LEN, MAZE_LEN, "right"), (TRAIN_B, 4, DH, MAZE_LEN, MAZE_LEN, "right"),
)


def phase_bwd_checks() -> dict:
    """K1, K2 and K3 against their plain versions on the card (`BWD_CASES`:
    the training shapes B=32, H=12, Dh=64 with T=160 and the trunk's
    all-zero bias, T=160 left-padded, and Tq=96 queries right-aligned over
    S=160 keys; a ragged T=100 and Tq=37 over S=100; Dh=128 at B=4, H=32,
    T=160), bf16 through the backward's tensor-core variant and f32
    through its CUDA-core variant; and K1 alone at the next-window
    forward's T=16, with and without padding. K1 is checked on the inputs
    the backward kernels then take."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    errs = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for T, padded in ((NEXT_T, False), (NEXT_T, True)):
            (q, k, v, bias, *_), rows, _ = _bwd_inputs(T, T, dtype, padded, gen)
            err, lse_err = _check_fwd(q, k, v, bias, rows, dtype, f"B={TRAIN_B} Tq=S={T} left_pad={padded}")
            errs["flash_fwd"] = max(errs["flash_fwd"], err)
            log(f"check flash_fwd B={TRAIN_B} H={H} Tq={T} S={T} left_pad={padded} {str(dtype)[6:]}: "
                f"max_abs_err={err:.3e} (atol, rtol {TOL[dtype]}) lse_err={lse_err:.3e}")
        for b, h, dh, Tq, S, padded in BWD_CASES:
            scale = 1.0 / dh**0.5
            args, rows, _ = _bwd_inputs(Tq, S, dtype, padded, gen, b, h, dh)
            q, k, v, bias, lse, delta, dout = args
            shape = f"B={b} H={h} Dh={dh} Tq={Tq} S={S}"
            fwd_err, lse_err = _check_fwd(q, k, v, bias, rows, dtype, f"{shape} padding={padded}")
            errs["flash_fwd"] = max(errs["flash_fwd"], fwd_err)
            tc0 = _tc_counts()
            dq = flash_bwd_dq(*args, True, scale)
            dk, dv = flash_bwd_dkv(*args, True, scale)
            n_tc = tuple(n - n0 for n, n0 in zip(_tc_counts(), tc0))
            want_tc = (1, 1) if dtype == torch.bfloat16 else (0, 0)
            check(n_tc == want_tc, f"flash_bwd {shape} {dtype}: tensor-core launches {n_tc}, want {want_tc}")
            ref_dq = _plain_bwd_dq(*args, True, scale)
            ref_dk, ref_dv = _plain_bwd_dkv(*args, True, scale)
            torch.cuda.synchronize()
            line = [f"variant={'tc' if n_tc[0] else 'simt'} flash_fwd_max_abs_err={fwd_err:.3e} lse_err={lse_err:.3e}"]
            for name, pairs in (("flash_bwd_dq", ((dq, ref_dq),)), ("flash_bwd_dkv", ((dk, ref_dk), (dv, ref_dv)))):
                err = max((a.float() - r.float()).abs().max().item() for a, r in pairs)
                over = max(((a.float() - r.float()).abs() - GRAD_TOL[dtype][1] * r.float().abs()).max().item()
                           for a, r in pairs)
                check(over <= GRAD_TOL[dtype][0], f"{name} {shape} bias={padded} {dtype}: max abs err {err} "
                                                  f"over tolerance {GRAD_TOL[dtype]}")
                errs[name] = max(errs[name], err)
                line.append(f"{name}_max_abs_err={err:.3e}")
            t_dq = cuda_ms(lambda: flash_bwd_dq(*args, True, scale))
            t_dkv = cuda_ms(lambda: flash_bwd_dkv(*args, True, scale))
            t_pdq = cuda_ms(lambda: _plain_bwd_dq(*args, True, scale))
            t_pdkv = cuda_ms(lambda: _plain_bwd_dkv(*args, True, scale))
            t_lib = sdpa_bwd_ms(q, k, v, bias, dout, scale, causal_only=not padded and Tq == S)
            log(f"check flash_bwd {shape} offset={S - Tq} padding={padded} {str(dtype)[6:]}: "
                + " ".join(line) + f" (atol, rtol fwd {TOL[dtype]}, bwd {GRAD_TOL[dtype]}) dq_ms={t_dq:.4f} dkv_ms={t_dkv:.4f} "
                f"plain_dq_ms={t_pdq:.4f} plain_dkv_ms={t_pdkv:.4f} library_bwd_ms={t_lib:.4f}")
    _check_bwd_live_pad_rows(gen, errs)
    return errs


def phase_path_checks() -> dict:
    """K1 and K4 against their plain versions at the shapes the later paths
    give them, bf16 (their dtype, so the tensor-core K1): the online
    rollout (B=256, H=12) and the gate's evals (B=512, H=4) — K1 at
    Tq=8 over S=8 and Tq=10 over S=68 and 128 of a T_MAX cache, K4 at
    index 8, 67 and 127; the text env's legal-set serving (B=8, prompts
    left-padded to T_MAX, a cache of T_MAX + 10) and LMServer's (B=4,
    prompts padded to 48, a cache of 58) — K1 on the left-padded prefill
    with bias, K4 with bias at the first, a middle and the last of the 10
    decode slots; the PPO rollout's LMServer (B=16, H=12) and the maze
    gate's evals (B=25, H=4), prompts left-padded to 160 with 12 new
    tokens, in bf16 and f32; and K1 on the score calls' 100 proposals
    right-padded to 160 (H=12 and 4), bf16 and f32. The online, gate, PPO
    and maze gate train steps' K1-K3 shapes are in BWD_CASES."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    dtype = torch.bfloat16
    errs = {"flash_fwd": 0.0, "decode_attn": 0.0}
    for b, h in ((256, H), (512, 4)):
        for Tq, S in ((8, 8), (10, 68), (10, T_MAX)):
            q, k, v, bias = _flash_inputs(Tq, S, dtype, False, gen, b, h, t_max=T_MAX)
            rows = torch.ones(b, Tq, dtype=torch.bool, device="cuda")
            err, lse_err = _check_fwd(q, k, v, bias, rows, dtype, f"B={b} H={h} Tq={Tq} S={S}")
            errs["flash_fwd"] = max(errs["flash_fwd"], err)
            log(f"check flash_fwd B={b} H={h} Tq={Tq} S={S} (cache view) bf16: max_abs_err={err:.3e} "
                f"(atol, rtol {TOL[dtype]}) lse_err={lse_err:.3e}")
        for index in (8, 67, 127):
            q, k, v, bias = _decode_inputs(index, dtype, False, gen, b, h)
            err = _check_decode(q, k, v, index, bias, dtype, f"B={b} H={h} index={index}")
            errs["decode_attn"] = max(errs["decode_attn"], err)
            log(f"check decode_attn B={b} H={h} T_max={T_MAX} index={index} bf16: max_abs_err={err:.3e}")
    # (batch, heads, prompt, new tokens, dtype): the text env, LMServer, the
    # PPO rollout's LMServer (B=16) and the maze gate's evals (d256 H4, 25
    # cells); the maze paths in f32 too (their CUDA-core K1)
    maze = [(16, H, MAZE_LEN, MAZE_NEW, dt) for dt in (dtype, torch.float32)]
    maze += [(25, 4, MAZE_LEN, MAZE_NEW, dt) for dt in (dtype, torch.float32)]
    for b, h, prompt, n_new, dtype in [(8, H, T_MAX, 10, dtype), (4, H, 48, 10, dtype)] + maze:
        t_max = prompt + n_new
        q, k, v, bias = _flash_inputs(prompt, prompt, dtype, True, gen, b, h, t_max=t_max)
        err, lse_err = _check_fwd(q, k, v, bias, bias == 0, dtype, f"B={b} H={h} prefill {prompt} left-padded")
        errs["flash_fwd"] = max(errs["flash_fwd"], err)
        log(f"check flash_fwd B={b} H={h} prefill Tq=S={prompt} of a {t_max} cache, left-padded {str(dtype)[6:]}: "
            f"max_abs_err={err:.3e} (atol, rtol {TOL[dtype]}) lse_err={lse_err:.3e}")
        for index in (prompt, prompt + n_new // 2, prompt + n_new - 1):
            q, k, v, bias = _decode_inputs(index, dtype, True, gen, b, h, t_max=t_max, max_pad=prompt - 1)
            err = _check_decode(q, k, v, index, bias, dtype, f"B={b} H={h} T_max={t_max} index={index} left-padded")
            errs["decode_attn"] = max(errs["decode_attn"], err)
            log(f"check decode_attn B={b} H={h} T_max={t_max} index={index} left-padded {str(dtype)[6:]}: "
                f"max_abs_err={err:.3e}")
    # the score calls: 25 cells x 4 move proposals, right-padded to 160
    for h in (H, 4):
        for dtype in (torch.bfloat16, torch.float32):
            (q, k, v, bias, *_), rows, _ = _bwd_inputs(MAZE_LEN, MAZE_LEN, dtype, "right", gen, 100, h)
            err, lse_err = _check_fwd(q, k, v, bias, rows, dtype, f"B=100 H={h} T={MAZE_LEN} right-padded")
            errs["flash_fwd"] = max(errs["flash_fwd"], err)
            log(f"check flash_fwd B=100 H={h} Tq=S={MAZE_LEN} right-padded (score call) {str(dtype)[6:]}: "
                f"max_abs_err={err:.3e} (atol, rtol {TOL[dtype]}) lse_err={lse_err:.3e}")
    return errs


def phase_train_shapes() -> dict:
    """Per-launch times at the shapes one ILQL train step launches, bf16
    with the trunk's all-zero bias: K2 and K3 at T=160 (12 each per step,
    the tensor-core variant; the library yardstick is SDPA's backward, one
    device time for the pair, which computes its own rowsum(dO ⊙ O), so
    the port's Δ pass and the pair plus Δ stand beside it); K1 at
    T=160 (24 per step: trained and target trunk) and T=16 (12: the
    next-window forward), logged per shape and returned as the mean over
    the step's 36 launches under "flash_fwd_train_step"."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    scale = 1.0 / DH**0.5
    dtype = torch.bfloat16
    args, _, fwd_out = _bwd_inputs(TRAIN_T, TRAIN_T, dtype, False, gen)
    q, k, v, bias, lse, delta, dout = args
    lib = sdpa_bwd_ms(q, k, v, bias, dout, scale, causal_only=True)
    t_delta = cuda_ms(lambda: _delta(fwd_out, dout))
    out = {}
    for name, fn, plain, kind in (("flash_bwd_dq", flash_bwd_dq, _plain_bwd_dq, "dq"),
                                  ("flash_bwd_dkv", flash_bwd_dkv, _plain_bwd_dkv, "dkv")):
        t_b, by = bound_ms(*bwd_work(TRAIN_B, TRAIN_T, TRAIN_T, dtype, kind, True), dtype)
        out[name] = dict(ms=cuda_ms(lambda: fn(*args, True, scale)), plain_ms=cuda_ms(lambda: plain(*args, True, scale)),
                         library_ms=lib, bound_ms=t_b, bound_by=by, delta_ms=t_delta)
    pair = out["flash_bwd_dq"]["ms"] + out["flash_bwd_dkv"]["ms"] + t_delta
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        out[name]["pair_plus_delta_ms"] = pair
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, simt_ms=0.0, n_bytes=0.0, flops=0.0)
    for T, per_step in ((TRAIN_T, 2), (NEXT_T, 1)):  # launches per layer and step at this shape
        (fq, fk, fv, fbias, *_), _, _ = _bwd_inputs(T, T, dtype, False, gen)
        row = dict(ms=cuda_ms(lambda: flash_fwd(fq, fk, fv, fbias, True, scale)),
                   plain_ms=cuda_ms(lambda: _plain_attention(fq, fk, fv, fbias, True, scale)),
                   library_ms=device_ms(lambda: sdpa(fq, fk, fv, is_causal=True, scale=scale)))
        with forced_variant("simt"):
            row["simt_ms"] = cuda_ms(lambda: flash_fwd(fq, fk, fv, fbias, True, scale))
        n_bytes, flops = (x * TRAIN_B / B for x in flash_work(T, T, dtype))
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, flops, dtype)
        log(f"train-step shapes flash_fwd B={TRAIN_B} T={T} (bf16, per launch): "
            + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()))
        for key in ("ms", "plain_ms", "library_ms", "simt_ms"):
            fwd[key] += per_step * row[key] / 3
        fwd["n_bytes"] += per_step * n_bytes / 3
        fwd["flops"] += per_step * flops / 3
    fwd["bound_ms"], fwd["bound_by"] = bound_ms(fwd.pop("n_bytes"), fwd.pop("flops"), dtype)
    out["flash_fwd_train_step"] = fwd
    log("train-step shapes flash_fwd (bf16, mean over a step's launches): "
        + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in fwd.items()))
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        row = out[name]
        log(f"train-step shapes {name} B={TRAIN_B} T={TRAIN_T} (bf16, per launch; library = SDPA backward of the pair): "
            + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()))
    return out


def phase_main_path_shapes() -> dict:
    """Mean per-launch times over the shapes one trunk's rollout launches:
    flash_fwd at (Tq=8, S=8) and (Tq=10, S=28..128 step 20); decode_attn at
    the 60 fills of the action slots. bf16, no padding bias (the actor's
    stream has none)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    scale = 1.0 / DH**0.5
    dtype = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flash_shapes = [(8, 8)] + [(10, 28 + 20 * t) for t in range(N_TRIES)]
    decode_index = [8 + 20 * t + s for t in range(N_TRIES) for s in range(10)]
    out = {}

    sums = [0.0, 0.0, 0.0, 0.0, 0.0]
    k_all = torch.randn(B, H, T_MAX, DH, device="cuda", generator=gen).to(dtype)
    v_all = torch.randn(B, H, T_MAX, DH, device="cuda", generator=gen).to(dtype)
    for Tq, S in flash_shapes:
        q = torch.randn(B, H, Tq, DH, device="cuda", generator=gen).to(dtype)
        k, v = k_all[:, :, :S], v_all[:, :, :S]  # the filled cache prefix, a strided view
        mask = sdpa_mask(None, Tq, S)
        sums[0] += cuda_ms(lambda: flash_fwd(q, k, v, None, True, scale))
        sums[1] += cuda_ms(lambda: _plain_attention(q, k, v, None, True, scale))
        sums[2] += cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=scale))
        sums[3] += bound_ms(*flash_work(Tq, S, dtype), dtype)[0]
        with forced_variant("simt"):
            sums[4] += cuda_ms(lambda: flash_fwd(q, k, v, None, True, scale))
    n = len(flash_shapes)
    out["flash_fwd"] = dict(
        ms=sums[0] / n, plain_ms=sums[1] / n, library_ms=sums[2] / n, bound_ms=sums[3] / n,
        bound_by=bound_ms(*flash_work(10, 128, dtype), dtype)[1], simt_ms=sums[4] / n,
    )

    sums = [0.0, 0.0, 0.0, 0.0]
    q = torch.randn(B, H, 1, DH, device="cuda", generator=gen).to(dtype)
    for index in decode_index:
        kp, vp = k_all[:, :, :index + 1], v_all[:, :, :index + 1]
        sums[0] += cuda_ms(lambda: decode_attention(q, k_all, v_all, index, None, scale), reps=10)
        sums[1] += cuda_ms(lambda: _plain_decode_attention(q, k_all, v_all, index, None, scale), reps=10)
        sums[2] += cuda_ms(lambda: sdpa(q, kp, vp, scale=scale), reps=10)
        sums[3] += bound_ms(*decode_work(index + 1, dtype), dtype)[0]
    n = len(decode_index)
    out["decode_attn"] = dict(
        ms=sums[0] / n, plain_ms=sums[1] / n, library_ms=sums[2] / n, bound_ms=sums[3] / n,
        bound_by=bound_ms(*decode_work(68, dtype), dtype)[1],
    )
    for name, row in out.items():
        log(f"main-path shapes {name} (bf16, mean per launch): " + " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()))
    return out


def _reset_counts():
    flash_fwd.launches = flash_fwd.tc_launches = 0
    decode_attention.launches = 0
    flash_bwd_dq.launches = flash_bwd_dq.tc_launches = 0
    flash_bwd_dkv.launches = flash_bwd_dkv.tc_launches = 0


def _counts():
    return flash_fwd.launches, decode_attention.launches


def _train_counts():
    return flash_fwd.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches


COUNT_NAMES = ("flash_fwd", "flash_fwd_tc", "decode_attn", "flash_bwd_dq", "flash_bwd_dq_tc", "flash_bwd_dkv",
               "flash_bwd_dkv_tc")


def _all_counts() -> tuple:
    """Every launch counter, in COUNT_NAMES' order (K1 and its tensor-core
    share, K4, K2 and its share, K3 and its share)."""
    return (flash_fwd.launches, flash_fwd.tc_launches, decode_attention.launches, flash_bwd_dq.launches,
            flash_bwd_dq.tc_launches, flash_bwd_dkv.launches, flash_bwd_dkv.tc_launches)


def _fmt_counts(counts: tuple) -> str:
    return " ".join(f"{n}={c}" for n, c in zip(COUNT_NAMES, counts))


def _check_rollout(out, env, batch: int = B, constrained: bool = True) -> None:
    """The rollout's invariants; a `constrained` decode also forces the
    action separators and makes every live guess a vocab word."""
    live = out.turn_live
    check(out.tokens.shape == (batch, actor.EPISODE_LEN), f"tokens shape {tuple(out.tokens.shape)}")
    check(bool((live[:, :-1] >= live[:, 1:]).all()), "turn liveness is not monotone")
    check(bool(live[:, 0].all()), "a game was done before its first turn")
    tr = out.turn_reward
    check(bool(torch.isfinite(tr).all() and ((tr >= -1) & (tr <= 0)).all()), "turn rewards outside [-1, 0]")
    check(bool((out.n_turns == live.sum(-1)).all()), "n_turns disagrees with turn_live")
    toks = out.tokens.cpu()
    header = torch.tensor(actor.HEADER)
    check(bool((toks[:, : len(actor.HEADER)] == header).all()), "header tokens")
    words = set(env.vocab.words)
    for t in range(N_TRIES):
        off = len(actor.HEADER) + t * actor.TURN_LEN
        act, obs = toks[:, off: off + 10], toks[:, off + 10: off + 20]
        check(bool((obs[:, 1:9:2] == 32).all() and (obs[:, 9] == 10).all()), f"turn {t}: observation separators")
        check(bool(torch.isin(obs[:, 0:10:2], torch.tensor([98, 121, 103])).all()), f"turn {t}: feedback letters")
        if not constrained:
            continue
        check(bool((act[:, 1:9:2] == 32).all() and (act[:, 9] == 10).all()), f"turn {t}: action separators")
        for b in torch.nonzero(live[:, t].cpu()).flatten().tolist():
            word = bytes(act[b, 0:10:2].tolist()).decode()
            check(word in words, f"turn {t} row {b}: constrained guess {word!r} is not a vocab word")


def _kernel_category(name: str) -> str:
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "decode_attn"):
        if f"{kernel}_kernel" in name:
            return kernel
        if f"{kernel}_tc_kernel" in name:
            return f"{kernel} (tensor cores)"
    low = name.lower()
    if "multi_tensor_apply" in low:
        return "optimizer (foreach)"
    if "gemm" in low or "nvjet" in low or "cutlass" in low or "xmma" in low:
        return "gemm f32" if "f32f32" in low or "sgemm" in low else "gemm bf16"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    if "reduce" in low:
        return "reduce"
    return "other"


def profile_run(label: str, run, unprofiled_s: float) -> None:
    """One more run (a rollout, a train step) under torch.profiler: device
    busy time (one stream, so the sum of kernel times) against the wall
    clock of this run and of the unprofiled one, the device time by kernel
    category and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    check(busy_ms > 0, "the profiler recorded no device time")
    log(f"profile {label}: wall_ms={wall_ms:.1f} device_busy_ms={busy_ms:.1f} idle_share={1 - busy_ms / wall_ms:.3f} "
        f"(against the unprofiled {label}: {1 - busy_ms / (unprofiled_s * 1e3):.3f})")
    by_cat: dict = {}
    for e in kernels:
        cat = _kernel_category(e.key)
        ms, n = by_cat.get(cat, (0.0, 0))
        by_cat[cat] = (ms + e.self_device_time_total / 1e3, n + e.count)
    for cat, (ms, n) in sorted(by_cat.items(), key=lambda kv: -kv[1][0]):
        log(f"  device {cat}: {ms:.1f} ms ({ms / wall_ms:.3f} of wall) in {n} launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  kernel {e.self_device_time_total / 1e3:8.1f} ms x{e.count:5d}  {e.key[:110]}")


def phase_slice() -> dict:
    config = gpt2_small().replace(pad_vocab_to_multiple=128, embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)
    check(config.vocab_size == 50257 and config.padded_vocab_size == 50304, "gpt2_small vocab")
    core = LMCore(config)
    t0 = time.perf_counter()
    pi_beta = init_params(config, seed=0, dtype=torch.bfloat16)
    base = init_params(config, seed=1, dtype=torch.bfloat16)
    head_cfg = MLPHeadConfig(input_dim=config.hidden_size, hidden_dim=2 * config.hidden_size,
                             output_dim=config.padded_vocab_size)
    q1, q2 = MLPHead(head_cfg, seed=2), MLPHead(head_cfg, seed=3)
    env = WordleVectorEnv(WordleVocab.from_file())
    params = {"pi_beta": pi_beta, "base": base, "q1": q1, "q2": q2}
    step_fn, carry0 = actor.make_value_guided_step_fn(core, B, two_trunks=True, twin_q=True, beta=32.0)
    torch.cuda.synchronize()
    log(f"slice setup (gpt2-small x2 bf16, twin MLP Q heads f32, B={B}): {time.perf_counter() - t0:.2f} s")

    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    actor.rollout_wordle(env, step_fn, params, carry0, B, constrain_vocab=True, generator=gen)
    torch.cuda.synchronize()
    log(f"warm-up rollout: {time.perf_counter() - t0:.3f} s")

    torch.cuda.reset_peak_memory_stats()
    times = []
    for rep in range(ROLLOUT_REPS):
        _reset_counts()
        t0 = time.perf_counter()
        out = actor.rollout_wordle(env, step_fn, params, carry0, B, constrain_vocab=True, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        n_flash, n_decode = _counts()
        check(n_flash == 7 * config.num_layers * 2, f"flash_fwd launched {n_flash} times, want 168")
        check(n_decode == 60 * config.num_layers * 2, f"decode_attn launched {n_decode} times, want 1440")
        check(flash_fwd.tc_launches == n_flash, f"flash_fwd: {flash_fwd.tc_launches} of {n_flash} launches on the tensor cores")
        _check_rollout(out, env)
        rollout_tc = flash_fwd.tc_launches
        ret = (out.turn_reward * out.turn_live).sum(1).mean().item()
        log(f"rollout {rep} B={B}: {times[-1]:.4f} s, launches flash_fwd={n_flash} (tensor cores "
            f"{flash_fwd.tc_launches}) decode_attn={n_decode}, "
            f"return={ret:.3f} win={out.win.float().mean().item():.3f} turns={out.n_turns.float().mean().item():.2f}")
    dt = sorted(times)[len(times) // 2]
    log(f"rollout median of {ROLLOUT_REPS}: {dt:.4f} s (min {min(times):.4f}, max {max(times):.4f}), "
        f"env_steps_per_s={B * N_TRIES / dt:.1f} tokens_per_s={B * actor.EPISODE_LEN / dt:.1f} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    profile_run(
        "rollout", lambda: actor.rollout_wordle(env, step_fn, params, carry0, B, constrain_vocab=True, generator=gen), dt
    )

    server = ValueGuidedServer(core, ByteTokenizer(), beta=32.0, share_trunk=False)
    prompts = [
        "Wordle:\n",
        "Wordle:\nc r a n e\nb b y b g\n",
        "Wordle:\nc r a n e\nb b y b g\nm o i s t\nb y b b b\n",
        "Wordle:\ns l a t e\ng b b b y\n",
    ]
    sampling = SamplingConfig(max_new_tokens=10, greedy=True, eos_token_id=10, pad_token_id=256)
    _reset_counts()
    t0 = time.perf_counter()
    answers = server.generate_from_strs(ValueRLParams(pi_beta, base, q1, q2, None), prompts, 48, sampling)
    torch.cuda.synchronize()
    n_flash, n_decode = _counts()
    log(f"server: {len(answers)} answers in {time.perf_counter() - t0:.3f} s, launches flash_fwd={n_flash} "
        f"decode_attn={n_decode}")
    check(len(answers) == len(prompts) and all(isinstance(a, str) for a in answers), "server answers")
    check(n_flash == config.num_layers * 2 and n_decode == 10 * config.num_layers * 2, "server launch counts")
    check(flash_fwd.tc_launches == n_flash, f"server: {flash_fwd.tc_launches} of {n_flash} flash_fwd launches on the tensor cores")
    log("  (random weights over the 50,257-token vocab: ids >= 256 have no byte and decode to nothing)")
    for p, a in zip(prompts, answers):
        log(f"  prompt {p!r} -> {a!r}")
    return {"flash_fwd": 7 * config.num_layers * 2, "flash_fwd_tc": rollout_tc, "decode_attn": 60 * config.num_layers * 2,
            "base": base, "config": config, "serving": ValueRLParams(pi_beta, base, q1, q2, None)}


@contextlib.contextmanager
def traced_online_round(record: list):
    """Wraps the calls `online_ilql_wordle` makes each round — the rollout
    and every train step — so each records its launch counts (set to 0
    just before the call, read just after it) and its wall time; the
    rollout also keeps its output and a copy of the trunk's final norm
    weights at the round's start."""
    rollout_wordle, make_step = actor.rollout_wordle, online_device.make_ilql_train_step

    def rollout(env, step_fn, params, *args, **kwargs):
        weights = params["base"].ln_f.weight.detach().clone()
        _reset_counts()
        t0 = time.perf_counter()
        out = rollout_wordle(env, step_fn, params, *args, **kwargs)
        torch.cuda.synchronize()
        record.append(dict(kind="rollout", s=time.perf_counter() - t0, counts=_all_counts(), out=out, weights=weights))
        return out

    def make(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def traced(*step_args, **step_kwargs):
            _reset_counts()
            t0 = time.perf_counter()
            res = step(*step_args, **step_kwargs)
            torch.cuda.synchronize()
            record.append(dict(kind="step", s=time.perf_counter() - t0, counts=_all_counts(), loss=res[1].item()))
            return res

        return traced

    actor.rollout_wordle, online_device.make_ilql_train_step = rollout, make
    try:
        yield
    finally:
        actor.rollout_wordle, online_device.make_ilql_train_step = rollout_wordle, make_step


def phase_online(config) -> dict:
    """Phase 3o: `online_ilql_wordle` at full width with its default config."""
    L = config.num_layers
    core = LMCore(config)
    t0 = time.perf_counter()
    base, q1, q2, v = _train_modules(config, "cuda")
    ilql_config = ILQLConfig(beta=32.0)
    state = init_ilql_state(base, q1, q2, v, adamw(1e-4), adamw(1e-3), ilql_config)
    ocfg = OnlineDeviceConfig()
    env = WordleVectorEnv(WordleVocab.from_file())
    gen = torch.Generator(device="cuda").manual_seed(7)
    torch.cuda.synchronize()
    n_steps = ocfg.rollout_batch // ocfg.train_bsize * ocfg.epochs_per_round
    log(f"online setup (gpt2-small f32 params, bf16 activations, twin MLP Q heads + V head, separate target base, "
        f"beta=32, {ocfg}): {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    record: list = []
    t0 = time.perf_counter()
    with traced_online_round(record):
        state, history = online_ilql_wordle(core, state, env, ilql_config, ocfg, generator=gen)
    total = time.perf_counter() - t0
    check(len(record) == ocfg.n_rounds * (1 + n_steps) and len(history) == ocfg.n_rounds,
          f"online: {len(record)} traced calls over {len(history)} rounds")
    want_roll = (7 * L, 7 * L, 60 * L, 0, 0, 0, 0)  # one trunk: 7 multi-token forwards, 60 decode steps
    want_step = (2 * L, 2 * L, 0, L, L, L, L)  # trained and target forwards (no next window), one backward
    roll_s, train_s = [], []
    for r in range(ocfg.n_rounds):
        roll, steps = record[r * (1 + n_steps)], record[r * (1 + n_steps) + 1: (r + 1) * (1 + n_steps)]
        check(roll["kind"] == "rollout" and all(st["kind"] == "step" for st in steps), f"online round {r}: call order")
        check(roll["counts"] == want_roll, f"online round {r} rollout: {_fmt_counts(roll['counts'])}, want {want_roll}")
        _check_rollout(roll["out"], env, ocfg.rollout_batch, constrained=False)
        for i, st in enumerate(steps):
            check(st["counts"] == want_step, f"online round {r} step {i}: {_fmt_counts(st['counts'])}, want {want_step}")
            check(math.isfinite(st["loss"]), f"online round {r} step {i}: loss {st['loss']}")
        if r:
            check(not torch.equal(record[(r - 1) * (1 + n_steps)]["weights"], roll["weights"]),
                  f"online round {r}: the trunk's weights did not move since round {r - 1}")
        roll_s.append(roll["s"])
        train_s.append(sum(st["s"] for st in steps))
        m = history[r]
        check(math.isfinite(m["loss"]), f"online round {r}: loss {m['loss']}")
        log(f"online round {r}: rollout B={ocfg.rollout_batch} {roll['s']:.3f} s ({_fmt_counts(roll['counts'])}), "
            f"train {train_s[-1]:.3f} s for {n_steps} steps B={ocfg.train_bsize} T={actor.EPISODE_LEN} "
            f"(per step {_fmt_counts(steps[0]['counts'])}; losses {[round(st['loss'], 4) for st in steps]}), "
            f"return {m['mean_episode_reward']:.3f} win {m['win_rate']:.3f} turns {m['mean_turns']:.2f}")
    log(f"online ILQL: {ocfg.n_rounds} rounds in {total:.3f} s; per round rollout {sum(roll_s) / len(roll_s):.3f} s, "
        f"train {sum(train_s) / len(train_s):.3f} s; peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")

    # the same two calls once more on the live modules, each under the profiler
    step_fn, carry0 = actor.make_value_guided_step_fn(core, ocfg.rollout_batch, two_trunks=False, twin_q=True,
                                                      beta=ilql_config.beta)
    policy = {"base": state.base.params, "q1": state.q1_head.params, "q2": state.q2_head.params}
    profile_run("online rollout", lambda: actor.rollout_wordle(env, step_fn, policy, carry0, ocfg.rollout_batch,
                                                               generator=gen), sorted(roll_s)[len(roll_s) // 2])
    batch = wordle_rollout_to_ilql_batch(actor.rollout_wordle(env, step_fn, policy, carry0, ocfg.rollout_batch,
                                                              generator=gen))
    step = make_ilql_train_step(core, ilql_config, ocfg.pad_token_id)
    mb = ocfg.train_bsize

    def train_round():
        for i in range(n_steps):
            step(state, ILQLBatch(*(None if x is None else x[i * mb: (i + 1) * mb] for x in batch)))

    profile_run("online train steps (one round)", train_round, sorted(train_s)[len(train_s) // 2])
    # the launches the last round recorded (every round's were checked above)
    last = record[-(1 + n_steps):]
    per_round = tuple(sum(c) for c in zip(*(call["counts"] for call in last)))
    out = {f"{name}_online_round": n for name, n in zip(COUNT_NAMES, per_round)}
    out.update({f"{name}_online_step": n for name, n in zip(COUNT_NAMES, last[-1]["counts"])})
    return out


GATE_ARGS = ["--bc-steps", "100", "--pbc-steps", "100", "--ilql-steps", "100", "--eval-every", "100",
             "--eval-batch", "512", "--optimal-episodes", "0"]
GATE_LAYERS = 4  # the gate's default --layers
GATE_LM_EVALS, GATE_GUIDED_EVALS = 4, 3  # BC and %BC, sampled and greedy; ILQL live, target and greedy


def phase_gate() -> dict:
    """Phase 3g: the port's Wordle ILQL gate at its own width and a cut budget."""
    L = GATE_LAYERS
    n_bc, n_ilql = 200, 100
    fwd = n_bc * L + n_ilql * 2 * L + GATE_LM_EVALS * 7 * L + GATE_GUIDED_EVALS * 2 * 7 * L
    dec = GATE_LM_EVALS * 60 * L + GATE_GUIDED_EVALS * 2 * 60 * L
    bwd = (n_bc + n_ilql) * L
    want = (fwd, fwd, dec, bwd, bwd, bwd, bwd)
    _reset_counts()
    t0 = time.perf_counter()
    result = wordle_ilql_gate.main(GATE_ARGS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _all_counts()
    check(counts == want, f"gate launched {_fmt_counts(counts)}, want {want}")
    returns = {k: v for k, v in result.items() if "return" in k and v is not None}
    returns.update({f"curve_{c['step']}": c["ret"] for c in result["curve"]})
    for k, v in returns.items():
        check(math.isfinite(v) and -6.0 <= v <= 0.0, f"gate {k} = {v}, want a finite return in [-6, 0]")
    log(f"gate ({' '.join(GATE_ARGS)}): {dt:.1f} s, {_fmt_counts(counts)}; "
        + " ".join(f"{k}={v:.3f}" for k, v in result.items() if isinstance(v, float)))
    out = {f"{name}_gate": n for name, n in zip(COUNT_NAMES, counts)}
    out["gate_s"] = dt
    return out


def phase_text_env(serving: ValueRLParams, config) -> dict:
    """Phase 3s: legal-set serving through the host text env, then LMServer."""
    L = config.num_layers
    core = LMCore(config)
    tok = ByteTokenizer()
    server = ValueGuidedServer(core, tok, beta=32.0)
    vocab = WordleVocab.from_file()
    proposals = [" ".join(w) + "\n" for w in vocab.words]
    sampling = SamplingConfig(max_new_tokens=10, eos_token_id=10, pad_token_id=256)
    calls: list = []

    def generate_batch(prompts, generator):
        calls.append(len(prompts))
        return server.generate_from_strs_legal(serving, prompts, [proposals] * len(prompts), actor.EPISODE_LEN,
                                               sampling, generator)

    policy = GenerationPolicy(generate_batch, torch.Generator(device="cuda").manual_seed(11))
    env = ReformatWordleEnv(WordleEnv(vocab))
    _reset_counts()
    t0 = time.perf_counter()
    interactions, summary = text_env_eval(env, policy, n_rollouts=8, seed_generator=iter(range(8)), bsize=8)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, n = _all_counts(), len(calls)
    want = (2 * L * n, 2 * L * n, 20 * L * n, 0, 0, 0, 0)  # per turn: two trunks' prefill and 10 decode steps
    check(counts == want, f"text env: {_fmt_counts(counts)} over {n} turns, want {want}")
    check(len(interactions) == 8, f"text env: {len(interactions)} games")
    legal = set(proposals)
    for g, game in enumerate(interactions):
        check(1 <= len(game) <= N_TRIES and game[-1].done, f"text env game {g}: {len(game)} turns, done={game[-1].done}")
        for tr in game:
            action = tr.post_action_history[-1]
            check(action.is_action and action.text in legal, f"text env game {g}: action {action.text!r} is not a vocab word")
    log(f"text env: 8 ReformatWordleEnv games in {dt:.3f} s over {n} policy turns (batches {calls}), "
        f"{_fmt_counts(counts)}; return mean {summary['reward']['mean']:.3f} min {summary['reward']['min']:.1f} "
        f"max {summary['reward']['max']:.1f}, length mean {summary['length']['mean']:.2f}")
    log(f"  game 0: {' | '.join(tr.post_action_history[-1].text.strip() for tr in interactions[0])}")
    per_turn = {f"{name}_text_env_turn": c // n for name, c in zip(COUNT_NAMES, counts) if c}

    lm = LMServer(core, tok)
    prompts = ["Wordle:\n", "Wordle:\nc r a n e\nb b y b g\n", "Wordle:\ns l a t e\ng b b b y\n", "hello"]
    _reset_counts()
    t0 = time.perf_counter()
    answers = lm.generate_from_strs(serving.base, prompts, 48,
                                    SamplingConfig(max_new_tokens=10, greedy=True, eos_token_id=10, pad_token_id=256))
    torch.cuda.synchronize()
    counts = _all_counts()
    check(len(answers) == len(prompts) and all(isinstance(a, str) for a in answers), "LMServer answers")
    check(counts == (L, L, 10 * L, 0, 0, 0, 0), f"LMServer launched {_fmt_counts(counts)}")
    log(f"LMServer: {len(answers)} answers in {time.perf_counter() - t0:.3f} s, {_fmt_counts(counts)}: {answers}")
    return per_turn


def phase_card_vs_cpu(base, config) -> float:
    """Header prefill + 3 decode steps, B=4: card (bf16, kernels) vs CPU (f32, plain)."""
    b = 4
    cpu_cfg = config.replace(dtype="float32")
    cpu_model = Transformer(cpu_cfg, device="cpu")
    cpu_model.load_state_dict({k: v.float().cpu() for k, v in base.state_dict().items()})
    runs = []
    for model, cfg, device in ((base, config, "cuda"), (cpu_model, cpu_cfg, "cpu")):
        step_fn, cache = actor.make_lm_step_fn(LMCore(cfg, device=device), b)
        toks = [torch.tensor(actor.HEADER, device=device).expand(b, -1)]
        toks += [torch.full((b, 1), t, device=device) for t in (99, 32, 114)]  # "c r"
        logits = []
        with torch.inference_mode():
            for tk in toks:
                out, cache = step_fn(model, tk, cache)
                logits.append(out[:, -1, : config.vocab_size].float().cpu())
        runs.append(torch.stack(logits))
    err = (runs[0] - runs[1]).abs().max().item()
    log(f"card (bf16, kernels) vs CPU (f32, plain), B={b}, prefill + 3 steps: max logit diff {err:.4f} "
        f"(tol {LOGIT_TOL}; logits span {runs[1].min().item():.2f}..{runs[1].max().item():.2f})")
    check(err <= LOGIT_TOL, f"card vs CPU logits differ by {err}")
    return err


def _train_batch(device="cuda", b=TRAIN_B, t=TRAIN_T, nt=NEXT_T, seed=0) -> ILQLBatch:
    """bench.py's ILQL batch: random byte tokens, actions on every other
    token with reward −1 each, no episode done, a next window of nt tokens
    whose episode is done."""
    g = torch.Generator().manual_seed(seed)
    sta = torch.zeros(b, t - 1, dtype=torch.bool)
    sta[:, 1::2] = True
    batch = ILQLBatch(
        input_ids=torch.randint(1, 256, (b, t), generator=g), should_take_action=sta, rewards=-1.0 * sta.float(),
        dones=torch.zeros(b, dtype=torch.bool), next_token_ids=torch.randint(1, 256, (b, nt), generator=g),
        next_dones=torch.ones(b, dtype=torch.bool),
    )
    return ILQLBatch(*(x.to(device) for x in batch))


def _train_modules(config, device, seed=0, layer2_initializer_range=0.0):
    """Trunk (f32 parameters) and the twin MLP Q heads and V head at hidden
    2·D, second layer zero-initialized as bench.py builds them."""
    D = config.hidden_size
    q_cfg = MLPHeadConfig(D, 2 * D, config.padded_vocab_size, layer2_initializer_range=layer2_initializer_range)
    v_cfg = MLPHeadConfig(D, 2 * D, 1, layer2_initializer_range=layer2_initializer_range)
    return (init_params(config, seed=seed, device=device), MLPHead(q_cfg, device=device, seed=seed + 1),
            MLPHead(q_cfg, device=device, seed=seed + 2), MLPHead(v_cfg, device=device, seed=seed + 3))


def _n_params(module) -> int:
    return sum(p.numel() for p in module.parameters())


def ilql_update_flops(config, n_base: int, n_head: int, n_v: int) -> float:
    """One ILQL update's FLOPs as bench.py counts them (bench.py:319-337):
    the trained trunk forward+backward, the target and next-window trunk
    forwards, forward+backward of q1/q2/v, the target heads' forwards and
    the attention products."""
    L, Hh, Dh = config.num_layers, config.num_heads, config.head_dim
    tok_main, tok_next = TRAIN_B * TRAIN_T, TRAIN_B * NEXT_T
    attn_fwd = 4 * L * Hh * Dh * TRAIN_T * tok_main
    return (tok_main * 6 * n_base + tok_main * 2 * n_base + tok_next * 2 * n_base
            + tok_main * (2 * 6 * n_head + 6 * n_v) + tok_main * 2 * 2 * n_head + 3 * attn_fwd)


def phase_train(config) -> dict:
    """The ILQL train step at bench.py::bench_ilql_real_vocab's operating
    point, then three BC steps on the same trunk."""
    L = config.num_layers
    want = (3 * L, L, L)  # trained, target and next-window trunk forwards; one backward
    core = LMCore(config)
    t0 = time.perf_counter()
    base, q1, q2, v = _train_modules(config, "cuda")
    ilql_config = ILQLConfig()
    state = init_ilql_state(base, q1, q2, v, adamw(1e-4), adamw(1e-3), ilql_config)
    step = make_ilql_train_step(core, ilql_config, PAD_ID)
    batch = _train_batch()
    torch.cuda.synchronize()
    log(f"train setup (gpt2-small f32 params, bf16 activations, separate target base, twin MLP Q heads + V head, "
        f"B={TRAIN_B} T={TRAIN_T} next={NEXT_T}): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    state, loss, _ = step(state, batch)
    check(bool(torch.isfinite(loss)), f"warm-up ILQL loss {loss.item()}")
    log(f"warm-up ILQL step: {time.perf_counter() - t0:.3f} s, loss {loss.item():.4f}")

    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    t_all = time.perf_counter()
    for _ in range(TRAIN_REPS):
        _reset_counts()
        t0 = time.perf_counter()
        state, loss, logs = step(state, batch)
        # host time of the call: the host blocks once CUDA's launch queue is
        # full, so a value near the step time means the device sets the pace
        times.append(time.perf_counter() - t0)
        counts = _train_counts()
        check(counts == want, f"ILQL step launched flash_fwd/bwd_dq/bwd_dkv {counts}, want {want}")
        check(_tc_counts() == (L, L), f"ILQL step: tensor-core backward launches {_tc_counts()}, want {(L, L)}")
        check(flash_fwd.tc_launches == 3 * L, f"ILQL step: tensor-core forward launches {flash_fwd.tc_launches}, want {3 * L}")
        step_counts = counts + _tc_counts() + (flash_fwd.tc_launches,)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t_all
    losses = torch.stack(losses).cpu()
    check(bool(torch.isfinite(losses).all()), f"ILQL losses {losses.tolist()}")
    flops = ilql_update_flops(config, _n_params(base), _n_params(q1), _n_params(v))
    ups = TRAIN_REPS / dt
    log(f"ILQL train: {TRAIN_REPS} steps in {dt:.4f} s: updates_per_s={ups:.3f} tokens_per_s={ups * TRAIN_B * TRAIN_T:.1f} "
        f"mfu={flops * ups / PEAK_FLOPS[torch.bfloat16]:.4f} (bench.py's count {flops / 1e12:.3f} TFLOP per update "
        f"over 989 TF/s) peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"host_ms_per_step_call={1e3 * sum(times) / len(times):.1f}; launches per step {want}, "
        f"tensor-core backward {step_counts[3:5]}, forward {step_counts[5]}; "
        f"losses {[round(x, 4) for x in losses.tolist()]}; last logs q1_loss={logs['losses']['q1_loss'].item():.4f} "
        f"v_loss={logs['losses']['v_loss'].item():.4f} q1_cql={logs['losses']['q1_cql_loss'].item():.4f}")
    profile_run("train step", lambda: step(state, batch), dt / TRAIN_REPS)

    bc_state = BCTrainState(TrainState(state.base.params, adamw(1e-4)))
    bc_step = make_bc_train_step(core, BCConfig(), PAD_ID)
    training_mask = torch.zeros(TRAIN_B, TRAIN_T, dtype=torch.int32, device="cuda")
    training_mask[:, 2::2] = 1  # the action tokens of the ILQL batch
    bc_batch = BCBatch(batch.input_ids, training_mask)
    for i in range(3):
        _reset_counts()
        t0 = time.perf_counter()
        bc_state, bc_loss, _ = bc_step(bc_state, bc_batch)
        torch.cuda.synchronize()
        counts = _train_counts()
        check(counts == (L, L, L), f"BC step launched {counts}, want {(L, L, L)}")
        check(_tc_counts() == (L, L), f"BC step: tensor-core backward launches {_tc_counts()}, want {(L, L)}")
        check(flash_fwd.tc_launches == L, f"BC step: tensor-core forward launches {flash_fwd.tc_launches}, want {L}")
        check(bool(torch.isfinite(bc_loss)), f"BC loss {bc_loss.item()}")
        log(f"BC step {i} B={TRAIN_B} T={TRAIN_T}: {time.perf_counter() - t0:.4f} s, loss {bc_loss.item():.4f}, "
            f"launches {counts}, tensor-core backward {_tc_counts()}, forward {flash_fwd.tc_launches}")
    names = ("flash_fwd_train_step", "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dq_tc", "flash_bwd_dkv_tc",
             "flash_fwd_tc_train_step")
    return dict(zip(names, step_counts))


def phase_train_card_vs_cpu(config) -> None:
    """One full-width ILQL step's loss and gradients, f32, B=2, T=32: the
    card (kernels) against the CPU (plain versions). Heads with a nonzero
    second layer, so every group's gradient is nonzero."""
    cfg = config.replace(dtype="float32")
    cpu_modules = _train_modules(cfg, "cpu", seed=5, layer2_initializer_range=None)
    batch = _train_batch("cpu", b=2, t=32, nt=8, seed=1)
    runs = []
    for d in ("cuda", "cpu"):
        mods = [copy.deepcopy(m).to(d) for m in cpu_modules]
        state = init_ilql_state(*mods, adamw(1e-4), adamw(1e-3), ILQLConfig())
        _reset_counts()
        loss, _, grads = ilql_loss_and_grads(LMCore(cfg, device=d), state, ILQLBatch(*(x.to(d) for x in batch)),
                                             ILQLConfig(), PAD_ID)
        if d == "cuda":
            L = cfg.num_layers
            check(_train_counts() == (3 * L, L, L), f"card step launches {_train_counts()}")
            check(_tc_counts() == (0, 0), f"f32 card step: tensor-core backward launches {_tc_counts()}, want none")
            check(flash_fwd.tc_launches == 0, f"f32 card step: tensor-core forward launches {flash_fwd.tc_launches}, want none")
        runs.append((loss.item(), [{k: g.cpu() for k, g in group.items()} for group in grads]))
        del state, mods
    (l_card, g_card), (l_cpu, g_cpu) = runs
    rel_loss = abs(l_card - l_cpu) / abs(l_cpu)
    rel = {}
    for name, ga, gb in zip(("base", "q1", "q2", "v"), g_card, g_cpu):
        num = sum(((ga[k] - gb[k]).double() ** 2).sum() for k in gb) ** 0.5
        den = sum((gb[k].double() ** 2).sum() for k in gb) ** 0.5
        rel[name] = float(num / den)
    log(f"ILQL step card (f32, kernels) vs CPU (f32, plain), full width B=2 T=32: loss {l_card:.6f} vs {l_cpu:.6f} "
        f"(rel {rel_loss:.2e}, tol {STEP_LOSS_RTOL}); gradient rel norm diff "
        + " ".join(f"{k}={v:.2e}" for k, v in rel.items()) + f" (tol {STEP_GRAD_RTOL})")
    check(rel_loss <= STEP_LOSS_RTOL, f"card vs CPU ILQL loss rel diff {rel_loss}")
    for name, r in rel.items():
        check(r <= STEP_GRAD_RTOL, f"card vs CPU ILQL {name} gradient rel diff {r}")


# ---------------- slice 6: MC, CQL, PPO, reranking, the maze gate ----------------

SLICE6_REPS = 5  # timed steps of the MC and CQL steps (after one warm-up)
PPO_EPISODES, PPO_BSIZE, PPO_MAX_STEPS = 32, 16, 8  # maze episodes cut to 8 moves (+ the failure turn)
MAZE_GATE_ARGS = ["--n-chains", "50", "--bc-epochs", "1", "--ilql-epochs", "2", "--lr-warmdown", "--guided-legal"]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _counted(fn, *args, device="cuda", **kwargs):
    """fn(*args, **kwargs) with every launch counter set to 0 just before
    the call and read just after it: (result, counts, seconds)."""
    _reset_counts()
    t0 = time.perf_counter()
    res = fn(*args, **kwargs)
    _sync(device)
    return res, _all_counts(), time.perf_counter() - t0


def _want(L: int, fwd: int = 0, dec: int = 0, bwd: int = 0) -> tuple:
    """Expected counts in COUNT_NAMES' order for `fwd` trunk forwards,
    `dec` single-token decode steps and `bwd` trunk backwards of L layers,
    every K1-K3 launch on the tensor-core variant (bf16, Dh=64)."""
    return (fwd * L, fwd * L, dec * L, bwd * L, bwd * L, bwd * L, bwd * L)


def _path_counts(path: str, counts: tuple) -> dict:
    return {f"{name}_{path}": n for name, n in zip(COUNT_NAMES, counts)}


def _timed_steps(label: str, step, state, batch, want: tuple, device="cuda") -> dict:
    """One warm-up, SLICE6_REPS steps each with its exact launch counts and
    a finite loss, then one step under torch.profiler. Returns the last
    step's counts, updates per second and peak memory."""
    state, loss, _ = step(state, batch)
    check(bool(torch.isfinite(loss)), f"{label}: warm-up loss {loss.item()}")
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses = []
    t_all = time.perf_counter()
    for i in range(SLICE6_REPS):
        _reset_counts()
        state, loss, logs = step(state, batch)
        counts = _all_counts()
        check(counts == want, f"{label} step {i}: {_fmt_counts(counts)}, want {want}")
        losses.append(loss)
    _sync(device)
    dt = time.perf_counter() - t_all
    losses = torch.stack(losses).cpu()
    check(bool(torch.isfinite(losses).all()), f"{label}: losses {losses.tolist()}")
    peak = torch.cuda.max_memory_allocated() / 1e9 if torch.device(device).type == "cuda" else 0.0
    ups = SLICE6_REPS / dt
    log(f"{label}: {SLICE6_REPS} steps in {dt:.4f} s: updates_per_s={ups:.3f} "
        f"tokens_per_s={ups * batch.input_ids.numel():.1f} peak_mem_gb={peak:.2f}; per step {_fmt_counts(counts)}; "
        f"losses {[round(x, 4) for x in losses.tolist()]}; "
        + " ".join(f"{k}={v.item():.4f}" for k, v in logs["losses"].items()))
    profile_run(label, lambda: step(state, batch), dt / SLICE6_REPS)
    return dict(counts=counts, updates_per_s=ups, peak_mem_gb=peak)


def _compare_card_cpu(label: str, runs, names) -> None:
    """Loss within STEP_LOSS_RTOL relative, each group's gradient within
    STEP_GRAD_RTOL in relative norm (card first, CPU second in `runs`)."""
    (l_card, g_card), (l_cpu, g_cpu) = runs
    rel_loss = abs(l_card - l_cpu) / abs(l_cpu)
    rel = {}
    for name, ga, gb in zip(names, g_card, g_cpu):
        num = sum(((ga[k] - gb[k]).double() ** 2).sum() for k in gb) ** 0.5
        den = sum((gb[k].double() ** 2).sum() for k in gb) ** 0.5
        rel[name] = float(num / den)
    log(f"{label} card (f32, kernels) vs CPU (f32, plain), full width B=2 T=32: loss {l_card:.6f} vs {l_cpu:.6f} "
        f"(rel {rel_loss:.2e}, tol {STEP_LOSS_RTOL}); gradient rel norm diff "
        + " ".join(f"{k}={v:.2e}" for k, v in rel.items()) + f" (tol {STEP_GRAD_RTOL})")
    check(rel_loss <= STEP_LOSS_RTOL, f"{label}: card vs CPU loss rel diff {rel_loss}")
    for name, r in rel.items():
        check(r <= STEP_GRAD_RTOL, f"{label}: card vs CPU {name} gradient rel diff {r}")


def _mc_batch(device="cuda", b=TRAIN_B, t=TRAIN_T, seed=0) -> MCBatch:
    """bench.py's token layout (actions on every other token) with a
    reward-to-go in [-5, 0] on each action token."""
    g = torch.Generator().manual_seed(seed)
    sta = torch.zeros(b, t - 1, dtype=torch.bool)
    sta[:, 1::2] = True
    batch = MCBatch(torch.randint(1, 256, (b, t), generator=g), sta, -5.0 * torch.rand(b, t - 1, generator=g) * sta)
    return MCBatch(*(x.to(device) for x in batch))


def phase_mc(config, device="cuda") -> dict:
    """Phase 3m: the MC-returns step at the ILQL step's operating point
    (GPT-2-small, f32 parameters, bf16 activations, one MLP Q head, AdamW,
    B=32, T=160), then one full-width f32 step on the card against the CPU."""
    L = config.num_layers
    base, q, _, _ = _train_modules(config, device)
    state = MCTrainState(TrainState(base, adamw(1e-4)), TrainState(q, adamw(1e-3)))
    step = make_mc_train_step(LMCore(config, device=device), MCConfig(), PAD_ID)
    res = _timed_steps("MC step (3m)", step, state, _mc_batch(device), _want(L, fwd=1, bwd=1), device)
    del state, base, q

    cfg = config.replace(dtype="float32")
    cpu_modules = _train_modules(cfg, "cpu", seed=5, layer2_initializer_range=None)[:2]
    batch = _mc_batch("cpu", b=2, t=32, seed=1)
    runs = []
    for d in (device, "cpu"):
        base, q = (copy.deepcopy(m).to(d) for m in cpu_modules)
        _reset_counts()
        loss, _ = mc_loss_from_params(LMCore(cfg, device=d), base, q, MCBatch(*(x.to(d) for x in batch)), MCConfig(),
                                      PAD_ID, train=True)
        grads = value_and_grads(loss, (base, q))
        if d != "cpu":
            check(_all_counts() == (L, 0, 0, L, 0, L, 0), f"f32 MC card step: {_fmt_counts(_all_counts())}")
        runs.append((loss.item(), [{k: g.cpu() for k, g in group.items()} for group in grads]))
    _compare_card_cpu("MC step", runs, ("base", "q"))
    return {**_path_counts("mc_step", res["counts"]), "mc_updates_per_s": res["updates_per_s"]}


def phase_cql(config, device="cuda") -> dict:
    """Phase 3c: the CQL step at the ILQL step's operating point, with a
    separate target base and a next window of 16 tokens, then one
    full-width f32 step on the card against the CPU."""
    L = config.num_layers
    base, q1, q2, _ = _train_modules(config, device)
    state = init_cql_state(base, q1, q2, adamw(1e-4), adamw(1e-3), CQLConfig())
    step = make_cql_train_step(LMCore(config, device=device), CQLConfig(), PAD_ID)
    # trained, target and next-window trunk forwards; one backward
    res = _timed_steps("CQL step (3c)", step, state, _train_batch(device), _want(L, fwd=3, bwd=1), device)
    del state, base, q1, q2

    cfg = config.replace(dtype="float32")
    cpu_modules = _train_modules(cfg, "cpu", seed=5, layer2_initializer_range=None)[:3]
    batch = _train_batch("cpu", b=2, t=32, nt=8, seed=1)
    runs = []
    for d in (device, "cpu"):
        state = init_cql_state(*(copy.deepcopy(m).to(d) for m in cpu_modules), adamw(1e-4), adamw(1e-3), CQLConfig())
        _reset_counts()
        loss, _ = cql_forward(LMCore(cfg, device=d), state.base.params, state.target_base_params, state.q1_head.params,
                              state.q2_head.params, state.q1_target_params, state.q2_target_params,
                              ILQLBatch(*(x.to(d) for x in batch)), CQLConfig(), PAD_ID, train=True)
        grads = value_and_grads(loss, (state.base.params, state.q1_head.params, state.q2_head.params))
        if d != "cpu":
            check(_all_counts() == (3 * L, 0, 0, L, 0, L, 0), f"f32 CQL card step: {_fmt_counts(_all_counts())}")
        runs.append((loss.item(), [{k: g.cpu() for k, g in group.items()} for group in grads]))
        del state
    _compare_card_cpu("CQL step", runs, ("base", "q1", "q2"))
    return {**_path_counts("cql_step", res["counts"]), "cql_updates_per_s": res["updates_per_s"],
            "cql_peak_mem_gb": res["peak_mem_gb"]}


def _maze_config(tok):
    """GPT-2-small's width over the byte tokenizer's vocab (259, padded to
    320), as the JAX maze PPO gate sizes its model to its tokenizer."""
    return gpt2_small().replace(vocab_size=tok.vocab_size, pad_vocab_to_multiple=64, embd_pdrop=0.0,
                                resid_pdrop=0.0, attn_pdrop=0.0)


def phase_ppo(device="cuda", config=None) -> dict:
    """Phase 3p: one PPO round on the maze at GPT-2-small width: LMServer
    rollouts through `GenerationPolicy` and `text_env_eval` (PPO_EPISODES
    episodes at batch PPO_BSIZE), `get_ppo_data_from_chains` through
    `make_ppo_forward_fn`, `block_ppo_data`, then PPO steps at B=32 without
    and with the BC term."""
    tok = ByteTokenizer()
    config = config or _maze_config(tok)
    L, pad = config.num_layers, tok.pad_token_id
    core = LMCore(config, device=device)
    policy = init_params(config, seed=20, device=device)
    init_policy = copy.deepcopy(policy).requires_grad_(False)
    value_head = LinearHead(LinearHeadConfig(config.hidden_size, 1), device=device, seed=21)
    server = LMServer(core, tok)
    sampling = SamplingConfig(max_new_tokens=MAZE_NEW, temperature=1.0, eos_token_id=10, pad_token_id=pad)
    turns = []

    def generate_batch(prompts, generator):
        res, counts, s = _counted(server.generate_from_strs, policy, prompts, MAZE_LEN, sampling, generator,
                                  device=device)
        turns.append(dict(n=len(prompts), counts=counts, s=s))
        return res

    env = build_maze_env(max_steps=PPO_MAX_STEPS)
    pol = GenerationPolicy(generate_batch, torch.Generator(device=device).manual_seed(13))
    t0 = time.perf_counter()
    interactions, summary = text_env_eval(env, pol, n_rollouts=PPO_EPISODES,
                                          seed_generator=iter(range(PPO_EPISODES)), bsize=PPO_BSIZE)
    t_roll = time.perf_counter() - t0
    check(len(interactions) == PPO_EPISODES and all(g and g[-1].done for g in interactions),
          f"PPO rollout: {len(interactions)} episodes, not all done")
    for i, turn in enumerate(turns):
        check(turn["counts"] == _want(L, fwd=1, dec=MAZE_NEW), f"PPO rollout turn {i}: {_fmt_counts(turn['counts'])}")
    log(f"PPO rollout (3p): {PPO_EPISODES} maze episodes at batch {PPO_BSIZE} in {t_roll:.3f} s over {len(turns)} "
        f"LMServer calls (per call {_fmt_counts(turns[0]['counts'])}, median {sorted(t['s'] for t in turns)[len(turns) // 2]:.4f} s); "
        f"return mean {summary['reward']['mean']:.2f} length mean {summary['length']['mean']:.2f}")
    if torch.device(device).type == "cuda":
        hist = [tr.pre_action_history for tr in interactions[0][:1]] * PPO_BSIZE
        profile_run("PPO rollout turn (LMServer, B=16)", lambda: generate_batch(
            [text_history_to_str(h) for h in hist], torch.Generator(device=device).manual_seed(14)), turns[0]["s"])

    chains = []
    for game in interactions:  # per-step Markov windows, chained, as the JAX maze PPO gate builds them
        chain = None
        for tr in reversed(game):
            chain = TextTrajectoryChain(TextTrajectory((tr.pre_action_history[-1], tr.post_action_history[-1]),
                                                       (0.0, tr.reward), tr.done), chain)
        chains.append(TokenTrajectoryChain.from_text_trajectory_chain(chain, tok))
    forward_fn = make_ppo_forward_fn(core, init_policy, policy, value_head, pad)
    fwd_calls = []

    def traced_forward(tokens):
        res, counts, s = _counted(forward_fn, tokens, device=device)
        fwd_calls.append(dict(counts=counts, s=s))
        return res

    t0 = time.perf_counter()
    datas, kls = get_ppo_data_from_chains(traced_forward, tok, chains, TRAIN_B, MAZE_LEN, gamma=0.99, lam=0.95,
                                          kl_weight=0.01)
    t_data = time.perf_counter() - t0
    for i, call in enumerate(fwd_calls):
        check(call["counts"] == _want(L, fwd=2), f"PPO forward call {i}: {_fmt_counts(call['counts'])}")
    check(len(kls) > 0 and bool(np.isfinite(kls).all()), "PPO data: KL estimates not finite")
    for d in datas:
        check(all(bool(np.isfinite(getattr(d, f)).all()) for f in ("old_logprobs", "old_values", "old_advantages",
                                                                   "old_returns")), "PPO data: a non-finite value")
    blocked = block_ppo_data(datas, BlockingStrategy(Padding.RIGHT, Truncation.RIGHT, MAZE_LEN), pad)
    log(f"PPO data (3p): {len(datas)} windows from {len(chains)} chains in {t_data:.3f} s over {len(fwd_calls)} "
        f"forward calls (per call {_fmt_counts(fwd_calls[0]['counts'])}); mean KL {float(np.mean(kls)):.3e}; "
        f"blocked {tuple(blocked['input_ids'].shape)}")

    state = PPOTrainState(TrainState(policy, adamw(1e-5)), TrainState(value_head, adamw(1e-4)))
    w0 = (policy.ln_f.weight.detach().clone(), value_head.dense.weight.detach().clone())
    n = blocked["input_ids"].shape[0]
    check(n >= 4 * TRAIN_B, f"PPO data: {n} windows, want at least {4 * TRAIN_B}")
    out = _path_counts("ppo_rollout_turn", turns[0]["counts"])
    out.update(_path_counts("ppo_forward", fwd_calls[0]["counts"]))
    for j, bc_weight in enumerate((0.0, 0.5)):
        step = make_ppo_train_step(core, PPOConfig(gamma=0.99, lam=0.95, bc_loss_weight=bc_weight), pad)
        for i in range(2):
            rows = slice((2 * j + i) * TRAIN_B, (2 * j + i + 1) * TRAIN_B)
            t = {k: torch.from_numpy(v[rows]).to(device) for k, v in blocked.items()}
            bc = {}
            if bc_weight:
                mask = torch.cat((torch.zeros_like(t["should_take_action"][:, :1]), t["should_take_action"]), 1)
                bc = dict(bc_input_ids=t["input_ids"].long(), bc_training_mask=mask.float())
            batch = PPOBatch(t["input_ids"].long(), t["should_take_action"], t["old_logprobs"], t["old_values"],
                             t["old_advantages"], t["old_returns"], **bc)
            (state, loss, logs), counts, s = _counted(step, state, batch, device=device)
            want = _want(L, fwd=2, bwd=2) if bc_weight else _want(L, fwd=1, bwd=1)
            check(counts == want, f"PPO step bc={bc_weight} {i}: {_fmt_counts(counts)}, want {want}")
            kl, vals = logs["policy"]["approx_kl"].item(), logs["values"]["mean"].item()
            check(all(math.isfinite(x) for x in (loss.item(), kl, vals)), f"PPO step: loss {loss.item()} kl {kl} values {vals}")
            log(f"PPO step (3p) bc_weight={bc_weight} {i}: {s:.4f} s, {_fmt_counts(counts)}, loss {loss.item():.4f} "
                f"approx_kl {kl:.3e} values~{vals:.3f}" + (f" bc_loss {logs['bc_loss'].item():.4f}" if bc_weight else ""))
        out.update(_path_counts("ppo_step_bc" if bc_weight else "ppo_step", counts))
        if torch.device(device).type == "cuda":
            profile_run(f"PPO step bc_weight={bc_weight}", lambda: step(state, batch), s)
    check(not torch.equal(w0[0], policy.ln_f.weight) and not torch.equal(w0[1], value_head.dense.weight),
          "PPO steps: the policy or the value head did not move")
    return {**out, "policy": policy, "config": config}


def phase_rerank(policy, config, device="cuda") -> dict:
    """Phase 3r: `ReRankerPolicy` over the maze's four move proposals in
    every cell, scored at GPT-2-small width by `make_ilql_score_fn` (twin Q
    and V; then with a π_β trunk and `logit_weight`) and `make_mc_score_fn`
    (twin Q, mean over the action tokens)."""
    tok = ByteTokenizer()
    L, D = config.num_layers, config.hidden_size
    core = LMCore(config, device=device)
    q_cfg = MLPHeadConfig(D, 2 * D, config.padded_vocab_size)
    q1, q2 = MLPHead(q_cfg, device=device, seed=31), MLPHead(q_cfg, device=device, seed=32)
    v = MLPHead(MLPHeadConfig(D, 2 * D, 1), device=device, seed=33)
    pi_beta = init_params(config, seed=34, device=device)
    maze = double_t_maze()
    cases = (
        ("ilql", make_ilql_score_fn(core, ValueRLParams(None, policy, q1, q2, v), tok.pad_token_id), 1),
        ("ilql+pi_beta", make_ilql_score_fn(core, ValueRLParams(pi_beta, policy, q1, q2, v), tok.pad_token_id,
                                            logit_weight=1.0), 2),
        ("mc", make_mc_score_fn(core, ValueRLParams(None, policy, q1, q2, None), tok.pad_token_id,
                                length_normalize=True), 1),
    )
    out = {}
    for name, score, n_trunks in cases:
        calls = []

        def score_batch(histories):
            ids, am = tokenize_histories_for_scoring(histories, tok, MAZE_LEN, device=device)
            res, counts, s = _counted(score, ids, am, device=device)
            calls.append(dict(counts=counts, s=s, n=len(histories), ids=ids, am=am))
            return res.cpu().numpy()

        reranker = ReRankerPolicy(proposal_fn=lambda h: [h + (Text(a, True),) for a in ACTION_STRS],
                                  score_batch=score_batch)
        acc, per_cell = per_cell_optimal_move_accuracy(lambda hs: reranker.act(hs), maze, (8, 6))
        check(0.0 <= acc <= 1.0 and all(a in ACTION_STRS for a, _ in per_cell.values()),
              f"rerank {name}: an action outside the proposals")
        for i, call in enumerate(calls):
            check(call["counts"] == _want(L, fwd=n_trunks), f"rerank {name} call {i}: {_fmt_counts(call['counts'])}")
        log(f"rerank (3r) {name}: accuracy {acc:.3f} over {len(per_cell)} cells, {len(calls)} score calls of "
            f"{calls[0]['n']} proposals, {calls[0]['s']:.4f} s, {_fmt_counts(calls[0]['counts'])}")
        if torch.device(device).type == "cuda":
            profile_run(f"score call {name}", lambda: score(calls[0]["ids"], calls[0]["am"]), calls[0]["s"])
        out.update(_path_counts("score_call" if name == "ilql" else f"score_call_{name.replace('+', '_')}",
                                calls[0]["counts"]))
    return out


def phase_maze_gate(device="cuda", extra=()) -> dict:
    """Phase 3z: the port's maze gate at its own width (d256 L4 H4, byte
    vocab) and a cut budget (MAZE_GATE_ARGS), --algo cql then --algo mc:
    exact launch counts for the budget and accuracies in [0, 1]."""
    args = maze_ilql_gate.parse_args(MAZE_GATE_ARGS + list(extra) + ["--device", device])
    L = args.layers
    chains = generate_maze_chains(args.n_chains, seed=args.seed, p_optimal=args.p_optimal, wrong_bias=True)
    n_windows = sum(len(c.to_list()) for c in chains)
    n_batches = -(-n_windows // args.bsize)
    n_evals = len([e for e in range(1, args.ilql_epochs + 1) if e % args.eval_every == 0 or e == args.ilql_epochs])
    out = {}
    for algo, value_fwd in (("cql", 3), ("mc", 1)):
        bc = _want(L, fwd=n_batches * args.bc_epochs, bwd=n_batches * args.bc_epochs)
        bc_eval = _want(L, fwd=1, dec=MAZE_NEW)  # LMServer over the 25 cells
        value = _want(L, fwd=value_fwd * n_batches * args.ilql_epochs, bwd=n_batches * args.ilql_epochs)
        # per eval: the two-trunk legal-set guided decode, two reranker score calls
        evals = _want(L, fwd=n_evals * (2 + 2), dec=n_evals * 2 * MAZE_NEW)
        want = tuple(sum(x) for x in zip(bc, bc_eval, value, evals))
        g = maze_ilql_gate.Gate(maze_ilql_gate.parse_args(MAZE_GATE_ARGS + list(extra) + ["--algo", algo,
                                                                                           "--device", device]))
        result, counts, s = _counted(maze_ilql_gate.run, g, device=device)
        check(counts == want, f"maze gate {algo}: {_fmt_counts(counts)}, want {want}")
        accs = [result["bc_acc"]] + [c[k] for c in result["curve"][1:] for k in ("acc", "rerank_acc", "target_rerank_acc")]
        check(len(result["curve"]) == 1 + n_evals and all(0.0 <= a <= 1.0 for a in accs),
              f"maze gate {algo}: curve {result['curve']}")
        log(f"maze gate (3z) --algo {algo} ({' '.join(MAZE_GATE_ARGS + list(extra))}): {s:.1f} s, {n_windows} windows, "
            f"{n_batches} batches per epoch, {_fmt_counts(counts)}; curve {result['curve']}")
        out.update(_path_counts(f"maze_gate_{algo}", counts))
        out[f"maze_gate_{algo}_s"] = s
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on the card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    try:
        card = phase_device()
        errs = phase_kernel_checks()
        for phase in (phase_bwd_checks, phase_path_checks):
            for name, err in phase().items():
                errs[name] = max(errs.get(name, 0.0), err)
        shapes = phase_main_path_shapes()
        shapes.update(phase_train_shapes())
        launches = phase_slice()
        launches.update(phase_train(launches["config"]))
        launches.update(phase_online(launches["config"]))
        launches.update(phase_gate())
        launches.update(phase_text_env(launches["serving"], launches["config"]))
        t_slice6 = time.perf_counter()
        launches.update(phase_mc(launches["config"]))
        launches.update(phase_cql(launches["config"]))
        ppo = phase_ppo()
        launches.update(phase_rerank(ppo.pop("policy"), ppo.pop("config")))
        launches.update(ppo)
        launches.update(phase_maze_gate())
        log(f"phases 3m, 3c, 3p, 3r, 3z: {time.perf_counter() - t_slice6:.1f} s")
        phase_card_vs_cpu(launches["base"], launches["config"])
        phase_train_card_vs_cpu(launches["config"])
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    replaces = {
        "flash_fwd": "lmrl_gym_tpu/ops/flash_attention.py:59",
        "flash_bwd_dq": "lmrl_gym_tpu/ops/flash_attention.py:182",
        "flash_bwd_dkv": "lmrl_gym_tpu/ops/flash_attention.py:229",
        "decode_attn": "lmrl_gym_tpu/ops/decode_attention.py:83",
    }
    # both main paths run K1, K2 and K3 on the tensor-core variant (bf16,
    # Dh=64); csrc/flash_fwd.cu and csrc/flash_bwd.cu keep f32 and Dh=256
    source = {"flash_fwd": "flash_fwd_tc", "flash_bwd_dq": "flash_bwd_tc", "flash_bwd_dkv": "flash_bwd_tc",
              "decode_attn": "decode_attn"}
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": f"lmrl_gym_torch/csrc/{source[name]}.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": shapes[name]["ms"],
            "plain_ms": shapes[name]["plain_ms"],
            "bound_ms": shapes[name]["bound_ms"],
            "bound_by": shapes[name]["bound_by"],
            "library_ms": shapes[name]["library_ms"],
        }
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "decode_attn")
    ]
    # flash_fwd runs on both paths: its serving row above, its train step here
    train_fwd = shapes["flash_fwd_train_step"]
    kernels[0].update(variant="tc", tc_launches=launches["flash_fwd_tc"],
                      launches_train_step=launches["flash_fwd_train_step"],
                      tc_launches_train_step=launches["flash_fwd_tc_train_step"], ms_train_step=train_fwd["ms"],
                      plain_ms_train_step=train_fwd["plain_ms"], bound_ms_train_step=train_fwd["bound_ms"],
                      bound_by_train_step=train_fwd["bound_by"], library_ms_train_step=train_fwd["library_ms"],
                      simt_ms=shapes["flash_fwd"]["simt_ms"], simt_ms_train_step=train_fwd["simt_ms"])
    for entry in kernels[1:3]:
        name = entry["name"]
        entry.update(variant="tc", tc_launches=launches[f"{name}_tc"], delta_ms=shapes[name]["delta_ms"],
                     pair_plus_delta_ms=shapes[name]["pair_plus_delta_ms"])
    # each kernel's launches on the later paths
    for entry in kernels:
        for path in ("online_round", "online_step", "gate", "text_env_turn", "mc_step", "cql_step", "ppo_step",
                     "ppo_step_bc", "ppo_forward", "ppo_rollout_turn", "score_call", "score_call_ilql_pi_beta",
                     "score_call_mc", "maze_gate_cql", "maze_gate_mc"):
            if f"{entry['name']}_{path}" in launches:
                entry[f"launches_{path}"] = launches[f"{entry['name']}_{path}"]
            if f"{entry['name']}_tc_{path}" in launches:
                entry[f"tc_launches_{path}"] = launches[f"{entry['name']}_tc_{path}"]
    log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
