"""The benchmark's yardstick of work: model FLOPs of an ILQL update and of a
value-guided rollout, worked out from the configuration file and the
traffic's shapes (never counted from the program's own operations), the
attention kernels' bytes and FLOPs for their rooflines, and the H100's
published peaks.

Model FLOPs count what the algorithm needs: 2 per multiply-add of every
matrix product whose output it reads, forward; a backward costs twice its
forward. Attention counts the causal (query, key) pairs only. A head or an
output projection counts at the positions whose outputs the algorithm reads
(ILQL: the Q heads where the loss reads them, the target Q heads' one
column per position; the rollout: the policy's logits and the Q heads at
the positions that choose a sampled letter). The float32 heads count
against the bf16 peak, as MFU is usually defined.
"""
from __future__ import annotations

from typing import Tuple

from benchmark.weights import padded_vocab

# H100 SXM published dense peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": PEAK_BF16}
ES = {"bfloat16": 2}


def trunk_body_params(cfg: dict) -> int:
    """Matrix parameters of the layers (q/k/v/out, fc, proj): the 2·N per
    token of a forward, without embeddings and the output projection."""
    D = cfg["n_embd"]
    M = cfg["n_inner"] or 4 * D
    return cfg["n_layer"] * (4 * D * D + 2 * D * M)


def causal_pairs(Tq: int, S: int) -> int:
    """Visible (query, key) pairs of Tq queries right-aligned over S keys."""
    return sum(S - Tq + i + 1 for i in range(Tq))


def attention_flops(cfg: dict, n_seqs: int, Tq: int, S: int) -> float:
    """QKᵀ and PV of one forward over the causal pairs, all layers."""
    return 4.0 * cfg["n_embd"] * cfg["n_layer"] * n_seqs * causal_pairs(Tq, S)


def ilql_update_flops(cfg: dict, B: int, T: int, next_T: int, n_actions: int) -> float:
    """One ILQL update: the trained trunk forward + backward, the target
    trunk and the next window forward; the Q heads forward + backward at
    the `n_actions` positions the loss reads, the V head at every position
    it reads (T − 1 per row, backward too) and once at each row's next
    window end; the target Q heads' first layer and their one read column
    at each action position."""
    D, V = cfg["n_embd"], padded_vocab(cfg)
    hq, hv = cfg["assumed"]["q_head_hidden"], cfg["assumed"]["v_head_hidden"]
    N = trunk_body_params(cfg)
    tok, nxt = B * T, B * next_T
    trunk = 6 * N * tok + 2 * N * tok + 2 * N * nxt
    attn = 3 * attention_flops(cfg, B, T, T) + attention_flops(cfg, B, T, T) + attention_flops(cfg, B, next_T, next_T)
    q_heads = 2 * 6 * (D * hq + hq * V) * n_actions
    v_head = 6 * (D * hv + hv) * B * (T - 1) + 2 * (D * hv + hv) * B
    target_q = 2 * 2 * (D * hq + hq) * n_actions
    return float(trunk + attn + q_heads + v_head + target_q)


def rollout_flops(cfg: dict, B: int, episode_len: int, served_positions: int) -> float:
    """One value-guided rollout of B games: both trunks' layers over every
    token of the episode (the caches need them), causal attention over the
    episode, and at each of `served_positions` per game the policy's
    output projection and the twin Q heads."""
    D, V = cfg["n_embd"], padded_vocab(cfg)
    hq = cfg["assumed"]["q_head_hidden"]
    N = trunk_body_params(cfg)
    trunks = 2 * (2 * N * B * episode_len + attention_flops(cfg, B, episode_len, episode_len))
    per_served = 2 * D * V + 2 * 2 * (D * hq + hq * V)
    return float(trunks + per_served * B * served_positions)


# ---- kernel work, for the rooflines: each input read once, each output
# written once, over the causal pairs ----

def bwd_work(b: int, h: int, dh: int, Tq: int, S: int, dtype: str, kernel: str, with_bias: bool) -> Tuple[float, float]:
    """Bytes and FLOPs of one backward kernel: both read q, k, v, dO, lse
    and Δ (and the bias when given); K2 writes dQ and does QKᵀ, dO·Vᵀ and
    dS·K (6·Dh FLOPs a pair), K3 writes dK and dV and adds Pᵀ·dO and dSᵀ·Q
    (8·Dh a pair)."""
    es = ES[dtype]
    n_q, n_kv = b * h * Tq * dh, b * h * S * dh
    n_bytes = es * (2 * n_q + 2 * n_kv) + 4 * 2 * b * h * Tq + (4 * b * S if with_bias else 0)
    n_bytes += es * (n_q if kernel == "dq" else 2 * n_kv)
    return float(n_bytes), (6.0 if kernel == "dq" else 8.0) * dh * b * h * causal_pairs(Tq, S)


def decode_work(b: int, h: int, dh: int, n_keys: int, dtype: str) -> Tuple[float, float]:
    """Bytes and FLOPs of one decode step (K4) over n_keys cache slots, no
    bias: q read, the output written, n_keys keys and values read."""
    es = ES[dtype]
    return float(es * b * h * dh * (2 + 2 * n_keys)), 4.0 * b * h * dh * n_keys


def least_seconds(n_bytes: float, flops: float, dtype: str) -> float:
    """The least time the chip could take: max(bytes / HBM bandwidth,
    FLOPs / the dtype's peak)."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def ilql_bwd_least_seconds(cfg: dict, B: int, T: int) -> float:
    """K2 + K3 of one update: every layer of the trained trunk, bf16, with
    the padding bias the step passes."""
    H = cfg["n_head"]
    dh = cfg["n_embd"] // H
    one = sum(least_seconds(*bwd_work(B, H, dh, T, T, "bfloat16", k, True), "bfloat16") for k in ("dq", "dkv"))
    return cfg["n_layer"] * one


def rollout_decode_least_seconds(cfg: dict, B: int, decode_cache_lens) -> float:
    """K4 of one rollout: both trunks, every layer, each single-token step
    over the slots it reads (`decode_cache_lens`: keys per step)."""
    H = cfg["n_head"]
    dh = cfg["n_embd"] // H
    per_trunk = sum(least_seconds(*decode_work(B, H, dh, n, "bfloat16"), "bfloat16") for n in decode_cache_lens)
    return 2 * cfg["n_layer"] * per_trunk
