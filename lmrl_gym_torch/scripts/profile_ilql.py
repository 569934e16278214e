"""Profile-backed MFU for the ILQL train step: the counterpart of
`scripts/profile_ilql.py`.

    python -m lmrl_gym_torch.scripts.profile_ilql [--vocab 50257] [--out PROFILE.json]
    python -m lmrl_gym_torch.scripts.profile_ilql --device cpu --vocab 259 --batch 2 --seq 16 --reps 1

It backs bench's analytic MFU with two measured sources, at the JAX
script's point (`build_step`: d768 L12 H12, its own vocab rules):

1. `counted_flops`: one step's matmul FLOPs as PyTorch's
   `FlopCounterMode` counts them, plus the attention kernels' FLOPs from
   their work formulas (`flash_work`, `bwd_work`) — the counterpart of
   XLA's `cost_analysis()['flops']` — over the measured step time.
   The counter does not see the kernels K1-K3 (foreign calls), and on the
   CPU it would see their plain versions' products; those are taken out,
   so the count is the same on either device by construction.
2. One `torch.profiler` run of three steps, device activity only (host
   events made the trace several times slower to read and changed no
   device number), read from the raw kineto events (`device_kernel_times`:
   the profiler's own `key_averages` costs ~180 µs a kernel): device busy
   and span, busy fraction, the time split by kernel category
   (`_kernel_category`) and the top ten kernels.

The JSON goes to stdout, and to `--out` only when asked. No trace is
dumped. On the CPU the step runs and is timed, and the profile is "not
measured": a CPU run has no device number to give.
"""
from __future__ import annotations

import argparse
import json
import torch

from lmrl_gym_torch.core.device import DeviceLike, resolve_device
from lmrl_gym_torch.models.config import TransformerConfig
from lmrl_gym_torch.ops import flash_attention as flash_module
from lmrl_gym_torch.scripts import bench

PROFILED_STEPS = 3
PROFILER_TRIES = 3  # torch.profiler now and then records no device event on the card's machine


def flash_work(b: int, h: int, dh: int, Tq: int, S: int, dtype) -> tuple:
    """Bytes (each input read once, each output written once) and FLOPs of
    one causal flash forward of shape (b, h, Tq, S, dh) without bias: QKᵀ
    and PV over the visible (query, key) pairs."""
    es = torch.finfo(dtype).bits // 8
    n_bytes = es * b * h * dh * (2 * Tq + 2 * S) + 4 * b * h * Tq
    pairs = sum(S - Tq + i + 1 for i in range(Tq))
    return n_bytes, 4.0 * b * h * dh * pairs


def bwd_work(b: int, h: int, dh: int, Tq: int, S: int, dtype, kernel: str, with_bias: bool) -> tuple:
    """Bytes and FLOPs of one backward kernel over the causal (query, key)
    pairs. Both read q, k, v, dO, lse and Δ (and the bias when given); K2
    writes dQ and does QKᵀ, dO·Vᵀ and dS·K (6·Dh FLOPs per pair), K3 writes
    dK and dV and adds Pᵀ·dO and dSᵀ·Q (8·Dh per pair)."""
    es = torch.finfo(dtype).bits // 8
    n_q, n_kv = b * h * Tq * dh, b * h * S * dh
    n_bytes = es * (2 * n_q + 2 * n_kv) + 4 * 2 * b * h * Tq + (4 * b * S if with_bias else 0)
    n_bytes += es * (n_q if kernel == "dq" else 2 * n_kv)
    pairs = b * h * sum(S - Tq + i + 1 for i in range(Tq))
    return n_bytes, (6.0 if kernel == "dq" else 8.0) * dh * pairs


def profile_config(vocab: int) -> TransformerConfig:
    """The JAX script's trunk: bench's d768 L12 H12, the vocab padded to a
    multiple of 128 above 1,000 ids, else 64."""
    return bench.ilql_config(vocab, 128 if vocab > 1000 else 64)


def build_step(vocab: int, B: int, T: int, device: DeviceLike = "cuda"):
    """(state, step, batch) at the JAX script's point (scripts/
    profile_ilql.py:34): bench's ILQL setup and batch on `profile_config`
    with the pad id min(vocab − 1, 256), which is 256 at 50,257 ids
    (bench.py passes 50,256; no batch token is either)."""
    return bench.ilql_setup(profile_config(vocab), B, T, min(vocab - 1, 256), device)


def _kernel_category(name: str) -> str:
    """The category of a CUDA kernel by name: K1-K4 by route (the port's
    csrc/ kernels), GEMMs by operand type, the optimizer's foreach
    kernels, elementwise, reduce, other."""
    for kernel, kid in (("flash_fwd", "K1"), ("flash_bwd_dq", "K2"), ("flash_bwd_dkv", "K3")):
        if f"{kernel}_tc_wide_kernel" in name:
            return f"{kid} {kernel} (tensor cores, Dh > 128)"
        if f"{kernel}_tc_kernel" in name:
            return f"{kid} {kernel} (tensor cores)"
        if f"{kernel}_kernel" in name:
            return f"{kid} {kernel} (CUDA cores)"
    for route in ("split", "wide"):
        if f"decode_attn_{route}_kernel" in name:
            return f"K4 decode_attn ({route})"
    if "decode_attn_kernel" in name:
        return "K4 decode_attn"
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


def device_kernel_times(prof) -> dict:
    """{kernel name: (device ms, launches)} of a finished torch.profiler
    run, summed straight from its raw events: building the profiler's
    own FunctionEvents (`key_averages`) took ~180 µs per kernel on the
    H100's host, 21 s for one GPT-J rollout's 117,000 kernels, for the same
    sums."""
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ms, n = out.get(e.name(), (0.0, 0))
            out[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return out


def _device_span_ms(prof) -> float:
    """From the first kernel's start to the last one's end."""
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    return (max(b for _, b in spans) - min(a for a, _ in spans)) / 1e6 if spans else 0.0


def profile_steps(step, state, batch, n: int = PROFILED_STEPS) -> dict:
    """`n` steps under torch.profiler (device activity only) → the JAX
    script's profile fields with the port's categories."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                state, loss, _ = step(state, batch)
            torch.cuda.synchronize()
            float(loss)
        kernels = device_kernel_times(prof)
        busy = sum(ms for ms, _ in kernels.values())
        if busy > 0:
            break
    else:
        raise RuntimeError(f"the profiler recorded no device time in {PROFILER_TRIES} tries")
    span = _device_span_ms(prof)
    split: dict = {}
    for name, (ms, _) in kernels.items():
        cat = _kernel_category(name)
        split[cat] = split.get(cat, 0.0) + ms / busy
    top10 = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "device_busy_ms": busy,
        "device_span_ms": span,
        "busy_fraction": busy / span if span else None,
        "time_split": dict(sorted(split.items(), key=lambda kv: -kv[1])),
        "top10_ops_ms": [[name, ms] for name, (ms, _) in top10],
        "per_step_busy_ms": busy / n,
        "launches_per_step": sum(c for _, c in kernels.values()) / n,
    }


def attention_flops(config: TransformerConfig, batch) -> int:
    """The attention kernels' FLOPs in one ILQL step, by their work
    formulas: per layer K1 on the trained and the target trunk's windows
    and on the next window, K2 and K3 on the trained window."""
    (B, T), nt = batch.input_ids.shape, batch.next_token_ids.shape[1]
    L, H, Dh, f32 = config.num_layers, config.num_heads, config.head_dim, torch.float32
    per_layer = (2 * flash_work(B, H, Dh, T, T, f32)[1] + flash_work(B, H, Dh, nt, nt, f32)[1]
                 + bwd_work(B, H, Dh, T, T, f32, "dq", True)[1] + bwd_work(B, H, Dh, T, T, f32, "dkv", True)[1])
    return int(L * per_layer)


def counted_flops(step, state, batch, config: TransformerConfig) -> int:
    """One ILQL step's FLOPs: the matmuls `FlopCounterMode` counts, less
    any it counts inside the attention kernels' plain versions (the CPU
    runs those; the card's kernels are foreign calls it never sees), plus
    `attention_flops`. Runs one more step on `state`."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    hidden = [0]
    names = ("_plain_attention", "_plain_bwd_dq", "_plain_bwd_dkv")
    originals = {name: getattr(flash_module, name) for name in names}

    def uncounted(fn):
        def wrapped(*args, **kw):
            before = counter.get_total_flops()
            out = fn(*args, **kw)
            hidden[0] += counter.get_total_flops() - before
            return out
        return wrapped

    try:
        for name, fn in originals.items():
            setattr(flash_module, name, uncounted(fn))
        with counter:
            step(state, batch)
    finally:
        for name, fn in originals.items():
            setattr(flash_module, name, fn)
    return int(counter.get_total_flops() - hidden[0]) + attention_flops(config, batch)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--vocab", type=int, default=50257)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seq", type=int, default=160)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--out", type=str, default=None, help="also write the JSON here")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    config = profile_config(args.vocab)
    state, step, batch = build_step(args.vocab, args.batch, args.seq, device)
    dt, _ = bench.time_ilql(state, step, batch, args.reps)
    flops = counted_flops(step, state, batch, config)
    peak = bench._peak_flops_per_chip(device)
    result = {
        "model": f"d{config.hidden_size} L{config.num_layers} H{config.num_heads} vocab{args.vocab} "
                 f"B{args.batch} T{args.seq}",
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "step_wall_ms": round(dt * 1e3, 2),
        "updates_per_s": round(1 / dt, 3),
        "counted_flops": flops,
        "counted_mfu_pct": round(100 * flops / dt / peak, 2),
        "peak_flops": peak,
        "profile": profile_steps(step, state, batch) if device.type == "cuda" else "not measured (cpu)",
    }
    print(json.dumps(result, indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
