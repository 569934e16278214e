"""Smoke test of lmrl_gym_torch on one CUDA card (an H100; the kernels
target sm_90a).

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. the card (`nvidia-smi` name and power limit) and the kernel build
   (`nvcc`, one process per source, from lmrl_gym_torch/csrc/);
2. each CUDA kernel against its plain PyTorch version on the card, at the
   serving path's shapes (B=512, H=12, Dh=64) in bf16 and f32, with the max
   abs error, its tolerance, and the kernel, plain and library
   (scaled_dot_product_attention, a yardstick the port never calls) times;
3. the slice at full width: value-guided Wordle serving with GPT-2-small
   (vocab 50,257 padded to 50,304), bf16 weights from a seed, two trunks,
   twin MLP Q heads, beta=32, constrained vocab, B=512 — one warm-up and five
   timed `rollout_wordle`s, each with the kernels' launch counts and the
   rollout's invariants checked, and one more under torch.profiler for the
   device busy time, idle share and device time by kernel category; then
   `ValueGuidedServer.generate_from_strs` answers 4 left-padded prompts;
4. the same full-width weights at B=4 on the card (kernels, bf16) against
   the CPU (plain path, f32): header prefill plus 3 decode steps;
5. a `{"kernels": [...]}` line: per kernel its launches on the main path
   and its mean time per launch over the main path's shapes beside the
   bound (bytes or FLOPs at the H100's published peaks), the plain
   version's and the library call's.

The last line is `{"ok": true, "device": {...}}`. Without a CUDA device the
script exits 2 and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from lmrl_gym_torch.algos.value_policy import ValueGuidedServer, ValueRLParams
from lmrl_gym_torch.envs.wordle.vector import N_TRIES, WordleVectorEnv, WordleVocab
from lmrl_gym_torch.loops import actor
from lmrl_gym_torch.models.config import gpt2_small
from lmrl_gym_torch.models.generation import SamplingConfig
from lmrl_gym_torch.models.heads import MLPHead, MLPHeadConfig
from lmrl_gym_torch.models.interface import LMCore
from lmrl_gym_torch.models.transformer import Transformer, init_params
from lmrl_gym_torch.ops import _build
from lmrl_gym_torch.ops.decode_attention import _plain_decode_attention, decode_attention
from lmrl_gym_torch.ops.flash_attention import _NEG_BIG, _plain_attention, flash_fwd
from lmrl_gym_torch.text.tokenizer import ByteTokenizer

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

B, H, DH, T_MAX = 512, 12, 64, actor.EPISODE_LEN
# kernel vs plain: |kernel − plain| ≤ atol + rtol·|plain|. f32: summation
# order only. bf16: two bf16 ulps, since both round the output (and the
# plain version its probabilities) to bf16.
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-2, 2.0**-6)}
# card (bf16 weights/activations, kernels) vs CPU (f32, plain path) logits
# after 12 layers: bf16 keeps ~3 significant digits per op, logits ~ ±3
LOGIT_TOL = 0.1
ROLLOUT_REPS = 5  # timed rollouts; the median is reported beside min and max


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean ms per call over `reps` back-to-back calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def sdpa_mask(bias, Tq: int, S: int):
    """Boolean [B,1,Tq,S] mask (True = attend) for the library yardstick."""
    q_pos = torch.arange(Tq, device="cuda") + (S - Tq)
    mask = (q_pos[:, None] >= torch.arange(S, device="cuda")[None, :])[None, None]
    if bias is not None:
        mask = mask & (bias == 0)[:, None, None, :]
    return mask.expand(B, 1, Tq, S)


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
    reports = _build.build_all(["flash_fwd", "decode_attn"])
    log(f"kernel build: {time.perf_counter() - t0:.2f} s for {sorted(reports) or 'nothing (cached)'}")
    for name, report in sorted(reports.items()):
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    return card


def _flash_inputs(Tq, S, dtype, padded, gen):
    q = torch.randn(B, H, Tq, DH, device="cuda", generator=gen).to(dtype)
    k = torch.randn(B, H, S, DH, device="cuda", generator=gen).to(dtype)
    v = torch.randn(B, H, S, DH, device="cuda", generator=gen).to(dtype)
    bias = None
    if padded:
        n_pad = torch.randint(0, S, (B,), device="cuda", generator=gen)
        bias = torch.where(torch.arange(S, device="cuda")[None, :] >= n_pad[:, None], 0.0, _NEG_BIG).float()
    return q, k, v, bias


def _decode_inputs(index, dtype, padded, gen):
    q = torch.randn(B, H, 1, DH, device="cuda", generator=gen).to(dtype)
    k = torch.randn(B, H, T_MAX, DH, device="cuda", generator=gen).to(dtype)
    v = torch.randn(B, H, T_MAX, DH, device="cuda", generator=gen).to(dtype)
    bias = None
    if padded:
        n_pad = torch.randint(0, index + 1, (B,), device="cuda", generator=gen)  # key `index` stays visible
        bias = torch.where(torch.arange(T_MAX, device="cuda")[None, :] >= n_pad[:, None], 0.0, _NEG_BIG).float()
    return q, k, v, bias


def phase_kernel_checks() -> dict:
    """Kernel vs plain on the card; returns {kernel: max abs error}."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    scale = 1.0 / DH**0.5
    errs = {"flash_fwd": 0.0, "decode_attn": 0.0}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dtype in (torch.bfloat16, torch.float32):
        for Tq, S, padded in ((8, 8, False), (10, 128, False), (64, 64, True)):
            q, k, v, bias = _flash_inputs(Tq, S, dtype, padded, gen)
            out, lse = flash_fwd(q, k, v, bias, True, scale)
            ref, ref_lse = _plain_attention(q, k, v, bias, True, scale)
            torch.cuda.synchronize()
            # fully padded query rows hold garbage in both: compare rows that see a key
            rows = torch.ones(B, Tq, dtype=torch.bool, device="cuda") if bias is None else bias[:, S - Tq:] == 0
            err = (out.float() - ref.float()).abs().amax(dim=(1, 3))[rows].max().item()
            over = excess(out, ref, dtype).amax(dim=(1, 3))[rows].max().item()
            lse_err = (lse - ref_lse).abs()[rows[:, None, :].expand_as(lse)].max().item()
            check(over <= TOL[dtype][0], f"flash_fwd Tq={Tq} S={S} {dtype}: max abs err {err} over tolerance {TOL[dtype]}")
            check(lse_err <= 1e-3, f"flash_fwd Tq={Tq} S={S} {dtype}: lse err {lse_err}")
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
                out = decode_attention(q, k, v, index, bias, scale)
                ref = _plain_decode_attention(q, k, v, index, bias, scale)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                over = excess(out, ref, dtype).max().item()
                check(over <= TOL[dtype][0], f"decode_attn index={index} bias={padded} {dtype}: max abs err {err}")
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

    sums = [0.0, 0.0, 0.0, 0.0]
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
    n = len(flash_shapes)
    out["flash_fwd"] = dict(
        ms=sums[0] / n, plain_ms=sums[1] / n, library_ms=sums[2] / n, bound_ms=sums[3] / n,
        bound_by=bound_ms(*flash_work(10, 128, dtype), dtype)[1],
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
    flash_fwd.launches = 0
    decode_attention.launches = 0


def _counts():
    return flash_fwd.launches, decode_attention.launches


def _check_rollout(out, env) -> None:
    live = out.turn_live
    check(out.tokens.shape == (B, actor.EPISODE_LEN), f"tokens shape {tuple(out.tokens.shape)}")
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
        check(bool((act[:, 1:9:2] == 32).all() and (act[:, 9] == 10).all()), f"turn {t}: action separators")
        check(bool((obs[:, 1:9:2] == 32).all() and (obs[:, 9] == 10).all()), f"turn {t}: observation separators")
        check(bool(torch.isin(obs[:, 0:10:2], torch.tensor([98, 121, 103])).all()), f"turn {t}: feedback letters")
        for b in torch.nonzero(live[:, t].cpu()).flatten().tolist():
            word = bytes(act[b, 0:10:2].tolist()).decode()
            check(word in words, f"turn {t} row {b}: constrained guess {word!r} is not a vocab word")


def _kernel_category(name: str) -> str:
    if "flash_fwd_kernel" in name:
        return "flash_fwd"
    if "decode_attn_kernel" in name:
        return "decode_attn"
    low = name.lower()
    if "gemm" in low or "nvjet" in low or "cutlass" in low or "xmma" in low:
        return "gemm f32" if "f32f32" in low or "sgemm" in low else "gemm bf16"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    if "reduce" in low:
        return "reduce"
    return "other"


def profile_rollout(run, unprofiled_s: float) -> None:
    """One more rollout under torch.profiler: device busy time (one stream,
    so the sum of kernel times) against the wall clock of this rollout and
    of the unprofiled median one, the device time by kernel category and the
    top kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    check(busy_ms > 0, "the profiler recorded no device time")
    log(f"profile: wall_ms={wall_ms:.1f} device_busy_ms={busy_ms:.1f} idle_share={1 - busy_ms / wall_ms:.3f} "
        f"(against the unprofiled median rollout: {1 - busy_ms / (unprofiled_s * 1e3):.3f})")
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
        _check_rollout(out, env)
        ret = (out.turn_reward * out.turn_live).sum(1).mean().item()
        log(f"rollout {rep} B={B}: {times[-1]:.4f} s, launches flash_fwd={n_flash} decode_attn={n_decode}, "
            f"return={ret:.3f} win={out.win.float().mean().item():.3f} turns={out.n_turns.float().mean().item():.2f}")
    dt = sorted(times)[len(times) // 2]
    log(f"rollout median of {ROLLOUT_REPS}: {dt:.4f} s (min {min(times):.4f}, max {max(times):.4f}), "
        f"env_steps_per_s={B * N_TRIES / dt:.1f} tokens_per_s={B * actor.EPISODE_LEN / dt:.1f} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    profile_rollout(
        lambda: actor.rollout_wordle(env, step_fn, params, carry0, B, constrain_vocab=True, generator=gen), dt
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
    log("  (random weights over the 50,257-token vocab: ids >= 256 have no byte and decode to nothing)")
    for p, a in zip(prompts, answers):
        log(f"  prompt {p!r} -> {a!r}")
    return {"flash_fwd": 7 * config.num_layers * 2, "decode_attn": 60 * config.num_layers * 2,
            "base": base, "config": config}


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on the card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    try:
        card = phase_device()
        errs = phase_kernel_checks()
        shapes = phase_main_path_shapes()
        launches = phase_slice()
        phase_card_vs_cpu(launches["base"], launches["config"])
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    replaces = {
        "flash_fwd": "lmrl_gym_tpu/ops/flash_attention.py:59",
        "decode_attn": "lmrl_gym_tpu/ops/decode_attention.py:83",
    }
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": f"lmrl_gym_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": shapes[name]["ms"],
            "plain_ms": shapes[name]["plain_ms"],
            "bound_ms": shapes[name]["bound_ms"],
            "bound_by": shapes[name]["bound_by"],
            "library_ms": shapes[name]["library_ms"],
        }
        for name in ("flash_fwd", "decode_attn")
    ]
    log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
