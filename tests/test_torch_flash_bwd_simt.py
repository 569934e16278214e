"""The CUDA-core backward kernels (`csrc/flash_bwd.cu`, K2's and K3's f32
route), on the CPU.

The kernels run only on the card (tests/test_torch_kernels.py and
chip_smoke.py hold them to their plain versions there). What is checked here:

(a) The tile schedule: a mirror of the kernels' index arithmetic. K2: which
    64 query rows each block owns, in the order the blocks take them (the
    longest key range first), which key tiles it streams up to `kv_end`,
    which 16-key blocks a warp skips on the causal diagonal and how far its
    dS·K pass reads. K3: which 64 key rows each block owns (key tile 0
    first), the query tiles it streams from the first query that sees its
    first key, which leading 16-query blocks a warp skips and which queries
    its dK/dV sums read. Thread (tr, tc) owns rows 4 tr + i and the
    streamed tile's columns tc + 16 j. Held against a brute-force causal
    mask over a grid of (Tq, S) with right-aligned queries and
    Dh ∈ {32, 48, 64, 128, 256} (streamed tiles of 64, 32 or 16 rows): every
    visible (query, key) pair reaches dQ exactly once, and dK and dV
    exactly once, and each (row, column) of a tile has exactly one owner.
(b) The kernels' f32 arithmetic, emulated in PyTorch over the mirrored
    schedule (s = scale·QKᵀ + bias, masked keys −0.7·f32max, P = exp(s −
    lse), dS = P ⊙ (dO·Vᵀ − Δ), zero on skipped blocks and past the
    sequence; sums tile by tile), against the JAX package's
    `_flash_backward` in f32 (its Pallas K2/K3 in interpret mode) and the
    port's plain versions, at chip_smoke.py's f32 GRAD_TOL (1e-4 abs +
    1e-5 rel: summation order only).
(c) Fully masked (left-pad) query rows: lse = −0.7·f32max makes P read 1 on
    every pair a block visits; their cotangent is zero, as every loss gives
    it, so their dQ is exactly 0 and dK, dV match the plain version.
(d) The wrapper's 16-byte rule, which the CUDA-core backward now takes too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lmrl_gym_tpu.ops.flash_attention as jfa
from lmrl_gym_torch.ops import flash_attention as tfa
from test_torch_ppo_gate_parity import one_thread  # noqa: F401  (one intra-op thread for this module)

NEG_BIG = -0.7 * float(np.finfo(np.float32).max)
GRAD_TOL = (1e-4, 1e-5)  # f32 (atol, rtol), as chip_smoke.py and tests/test_torch_kernels.py
ROWS, SIDE = 64, 16  # rows a block owns; the 16 x 16 thread grid


def stream_tile(head_dim: int) -> int:
    """Rows per streamed tile of the instantiation `dispatch_dq` and
    `dispatch_dkv` pick: keys (K2) or queries (K3)."""
    return 64 if head_dim <= 64 else 32 if head_dim <= 128 else 16


# ---- (a) the tile schedule -------------------------------------------------

def k2_blocks(Tq, S, head_dim, causal=True):
    """Mirror of flash_bwd_dq_kernel's launch for one (b, h): per block in
    launch order its first query row q0, kv_end and its key tiles."""
    bk, n = stream_tile(head_dim), (Tq + ROWS - 1) // ROWS
    blocks = []
    for bx in range(n):
        q0 = (n - 1 - bx) * ROWS  # the longest key ranges first
        q_last = min(q0 + ROWS, Tq) - 1
        kv_end = min(S, (S - Tq) + q_last + 1) if causal else S
        blocks.append(dict(q0=q0, kv_end=kv_end, n_tiles=(kv_end + bk - 1) // bk, bn=bk))
    return blocks


def k2_warp_limits(blk, t, Tq, S, causal=True):
    """Per warp (rows 8 w .. 8 w + 7): the 16-key blocks of tile t it scores
    (`live`) and the tile keys its dS·K pass reads (`k_end`)."""
    nj, j0 = blk["bn"] // SIDE, t * blk["bn"]
    warp_last = (S - Tq) + blk["q0"] + 8 * np.arange(ROWS // 8) + 7
    if not causal:
        return np.full(ROWS // 8, nj), np.full(ROWS // 8, blk["bn"])
    live = np.where(warp_last < j0, 0, np.minimum(nj, (warp_last - j0) // SIDE + 1))
    k_end = np.minimum(blk["bn"], (np.maximum(0, warp_last - j0 + 1) + 3) & ~3)
    return live, k_end


def k3_blocks(Tq, S, head_dim, causal=True):
    """Mirror of flash_bwd_dkv_kernel's launch for one (b, h): per block its
    first key row k0, the first query it streams and its query tiles."""
    bq, n = stream_tile(head_dim), (S + ROWS - 1) // ROWS
    blocks = []
    for bx in range(n):
        k0 = bx * ROWS  # key tile 0 (the most queries) first
        t_begin = max(0, k0 - (S - Tq)) if causal else 0
        blocks.append(dict(k0=k0, t_begin=t_begin, n_tiles=(Tq - t_begin + bq - 1) // bq, bn=bq))
    return blocks


def k3_warp_limits(blk, t, Tq, S, causal=True):
    """Per warp (keys 8 w .. 8 w + 7): the leading 16-query blocks of tile t
    it skips (`dead`) and the tile queries [qq_begin, qq_end) its sums read."""
    nj, t0 = blk["bn"] // SIDE, blk["t_begin"] + t * blk["bn"]
    qq_end = np.full(ROWS // 8, min(blk["bn"], (Tq - t0 + 3) & ~3))
    if not causal:
        return np.zeros(ROWS // 8, int), np.zeros(ROWS // 8, int), qq_end
    warp_first = blk["k0"] + 8 * np.arange(ROWS // 8) - (S - Tq)  # the first query that sees a key of the warp
    gap = np.maximum(0, warp_first - t0)
    return np.minimum(nj, gap // SIDE), np.minimum(blk["bn"], gap) & ~3, qq_end


def owners(bn):
    """Thread (tr, tc) of each (row, column) of a block's tile: rows 4 tr + i,
    columns tc + 16 j."""
    r, c = np.meshgrid(np.arange(ROWS), np.arange(bn), indexing="ij")
    return (r // 4) * SIDE + c % SIDE, r % 4, c // SIDE


def k2_reach(Tq, S, head_dim, causal=True):
    """How often each (query, key) pair's dS reaches dQ, and the pairs a
    block computes but whose dS no dS·K pass reads."""
    reach, lost = np.zeros((Tq, S), int), 0
    for blk in k2_blocks(Tq, S, head_dim, causal):
        bn = blk["bn"]
        rows = blk["q0"] + np.arange(ROWS)
        warp = np.arange(ROWS) // 8
        for t in range(blk["n_tiles"]):
            live, k_end = k2_warp_limits(blk, t, Tq, S, causal)
            keys = t * bn + np.arange(bn)
            computed = (np.arange(bn)[None, :] // SIDE < live[warp][:, None]) & (keys[None, :] < blk["kv_end"])
            computed &= rows[:, None] < Tq
            read = np.arange(bn)[None, :] < k_end[warp][:, None]
            rr, cc = np.nonzero(computed & read)
            np.add.at(reach, (rows[rr], keys[cc]), 1)
            lost += (computed & ~read).sum()
            # a block never streams a key past S
            assert (keys[computed.any(0)] < S).all()
    return reach, lost


def k3_reach(Tq, S, head_dim, causal=True):
    """How often each (query, key) pair reaches dK and dV, and the pairs a
    block computes but no sum reads."""
    reach, lost = np.zeros((Tq, S), int), 0
    for blk in k3_blocks(Tq, S, head_dim, causal):
        bn = blk["bn"]
        keys = blk["k0"] + np.arange(ROWS)
        warp = np.arange(ROWS) // 8
        for t in range(blk["n_tiles"]):
            dead, qq_begin, qq_end = k3_warp_limits(blk, t, Tq, S, causal)
            queries = blk["t_begin"] + t * bn + np.arange(bn)
            col = np.arange(bn)[None, :]
            computed = (col // SIDE >= dead[warp][:, None]) & (queries[None, :] < Tq) & (keys[:, None] < S)
            read = (col >= qq_begin[warp][:, None]) & (col < qq_end[warp][:, None])
            kk, cc = np.nonzero(computed & read)
            np.add.at(reach, (queries[cc], keys[kk]), 1)
            lost += (computed & ~read).sum()
    return reach, lost


GRID = [(1, 1), (1, 40), (8, 8), (10, 128), (16, 16), (37, 100), (63, 63), (63, 130), (64, 64), (65, 65), (65, 200),
        (100, 100), (100, 165), (129, 129), (129, 200), (160, 160), (200, 264), (256, 256), (448, 448)]


@pytest.mark.parametrize("head_dim", [32, 48, 64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_tile_schedule_reaches_every_visible_pair_once(head_dim, causal):
    for Tq, S in GRID:
        vis = ((np.arange(Tq)[:, None] + (S - Tq)) >= np.arange(S)[None, :]) if causal else np.ones((Tq, S), bool)
        k2 = k2_blocks(Tq, S, head_dim, causal)
        assert [b["q0"] for b in k2] == sorted((b["q0"] for b in k2), reverse=True)
        k3 = k3_blocks(Tq, S, head_dim, causal)
        assert [b["k0"] for b in k3] == sorted(b["k0"] for b in k3)
        for blk in k2:  # the block streams every key a live row of it sees
            live_rows = np.arange(blk["q0"], min(blk["q0"] + ROWS, Tq))
            assert not vis[np.ix_(live_rows, np.arange(blk["kv_end"], S))].any(), (Tq, S, blk)
            assert (blk["n_tiles"] - 1) * blk["bn"] < blk["kv_end"] <= S  # no tile wholly past it
        for blk in k3:  # and every query that sees a key of the block
            assert not vis[np.ix_(np.arange(blk["t_begin"]), np.arange(blk["k0"], min(blk["k0"] + ROWS, S)))].any()
            assert blk["n_tiles"] >= 1
        for reach_fn in (k2_reach, k3_reach):
            reach, lost = reach_fn(Tq, S, head_dim, causal)
            assert (reach[vis] == 1).all(), (reach_fn.__name__, Tq, S)  # every visible pair exactly once
            assert reach.max() <= 1
            # what a warp computes but no sum reads is hidden for its rows
            assert lost == 0 or causal
        tid, i, j = owners(stream_tile(head_dim))
        assert len(set(zip(tid.ravel(), i.ravel(), j.ravel()))) == tid.size  # one owner per (row, column)


def test_skipped_pairs_are_hidden():
    """A pair a warp skips (a dead 16-column block) or computes without
    reading is causally hidden from its row."""
    for dh in (32, 64, 128, 256):
        for Tq, S in GRID:
            off = S - Tq
            for blk in k2_blocks(Tq, S, dh):
                rows, warp = blk["q0"] + np.arange(ROWS), np.arange(ROWS) // 8
                for t in range(blk["n_tiles"]):
                    live, k_end = k2_warp_limits(blk, t, Tq, S)
                    keys = t * blk["bn"] + np.arange(blk["bn"])
                    unread = (np.arange(blk["bn"])[None, :] >= np.minimum(k_end, SIDE * live)[warp][:, None])
                    assert (keys[None, :] > off + rows[:, None])[unread].all()
            for blk in k3_blocks(Tq, S, dh):
                keys, warp = blk["k0"] + np.arange(ROWS), np.arange(ROWS) // 8
                for t in range(blk["n_tiles"]):
                    dead, qq_begin, _ = k3_warp_limits(blk, t, Tq, S)
                    queries = blk["t_begin"] + t * blk["bn"] + np.arange(blk["bn"])
                    unread = np.arange(blk["bn"])[None, :] < np.maximum(qq_begin, SIDE * dead)[warp][:, None]
                    assert (keys[:, None] > off + queries[None, :])[unread].all()


# ---- (b) the arithmetic -----------------------------------------------------

def _tile_scores(q_rows, k_rows, b_keys, q_pos, k_pos, scale, causal):
    """s = scale·QKᵀ + bias, masked to −0.7·f32max where a key lies past its
    query, f32 [B, H, rows, cols]."""
    s = torch.einsum("bhqd,bhkd->bhqk", q_rows, k_rows) * scale
    if b_keys is not None:
        s = s + b_keys[:, None, None, :]
    if causal:
        s = torch.where(k_pos[None, :] > q_pos[:, None], torch.tensor(NEG_BIG), s)
    return s


def simt_dq_emulation(q, k, v, bias, lse, delta, dout, scale, causal=True, record=None):
    """flash_bwd_dq's arithmetic over the mirrored schedule, f32: per block
    and key tile, P = exp(s − lse), dS = P (dO·Vᵀ − Δ), zero past kv_end,
    past Tq and on a warp's skipped key blocks; dQ += dS·K over the keys
    each warp reads; dQ · scale. `record` collects P on the pairs computed."""
    B, H, Tq, Dh = q.shape
    S = k.shape[2]
    dq = torch.zeros(B, H, Tq, Dh)
    for blk in k2_blocks(Tq, S, Dh, causal):
        rows = np.arange(blk["q0"], min(blk["q0"] + ROWS, Tq))
        warp = torch.from_numpy((rows - blk["q0"]) // 8)
        qr, dor = q[:, :, rows].float(), dout[:, :, rows].float()
        lr, dr = lse[:, :, rows][..., None], delta[:, :, rows][..., None]
        acc = torch.zeros(B, H, len(rows), Dh)
        bn = blk["bn"]
        for t in range(blk["n_tiles"]):
            live, k_end = (torch.from_numpy(x) for x in k2_warp_limits(blk, t, Tq, S, causal))
            keys = torch.arange(t * bn, (t + 1) * bn)
            valid = keys < blk["kv_end"]
            idx = keys.clamp(max=S - 1)
            kt = torch.where(valid[:, None], k[:, :, idx].float(), 0.0)
            vt = torch.where(valid[:, None], v[:, :, idx].float(), 0.0)
            bt = torch.where(valid, bias[:, idx].float(), 0.0) if bias is not None else None
            s = _tile_scores(qr, kt, bt, torch.from_numpy(rows + S - Tq), keys, scale, causal)
            p = torch.exp(s - lr)
            ds = p * (torch.einsum("bhqd,bhkd->bhqk", dor, vt) - dr)
            computed = (torch.arange(bn)[None, :] // SIDE < live[warp][:, None]) & valid[None, :]
            if record is not None:
                record.append((rows, keys[valid].numpy(), torch.where(computed, p, float("nan"))[..., valid]))
            ds = torch.where(computed & (torch.arange(bn)[None, :] < k_end[warp][:, None]), ds, 0.0)
            acc = acc + torch.einsum("bhqk,bhkd->bhqd", ds, kt)
        dq[:, :, rows] = acc * scale
    return dq.to(q.dtype)


def simt_dkv_emulation(q, k, v, bias, lse, delta, dout, scale, causal=True):
    """flash_bwd_dkv's arithmetic over the mirrored schedule, f32: per block
    and query tile, Pᵀ and dSᵀ, zero past Tq, past S and on a warp's
    skipped query blocks; dV += Pᵀ·dO and dK += dSᵀ·Q over the queries each
    warp reads; dK · scale."""
    B, H, Tq, Dh = q.shape
    S = k.shape[2]
    dk, dv = torch.zeros(B, H, S, Dh), torch.zeros(B, H, S, Dh)
    for blk in k3_blocks(Tq, S, Dh, causal):
        keys = np.arange(blk["k0"], min(blk["k0"] + ROWS, S))
        warp = torch.from_numpy((keys - blk["k0"]) // 8)
        kr, vr = k[:, :, keys].float(), v[:, :, keys].float()
        br = bias[:, keys].float() if bias is not None else None
        acc_k, acc_v = torch.zeros(B, H, len(keys), Dh), torch.zeros(B, H, len(keys), Dh)
        bn = blk["bn"]
        for t in range(blk["n_tiles"]):
            dead, qq_begin, qq_end = (torch.from_numpy(x) for x in k3_warp_limits(blk, t, Tq, S, causal))
            queries = blk["t_begin"] + t * bn + torch.arange(bn)
            valid = queries < Tq
            idx = queries.clamp(max=Tq - 1)
            qt = torch.where(valid[:, None], q[:, :, idx].float(), 0.0)
            dot = torch.where(valid[:, None], dout[:, :, idx].float(), 0.0)
            lt, dt = lse[:, :, idx][:, :, None, :], delta[:, :, idx][:, :, None, :]
            # [keys, queries]: the transposed scores (the bias is per key row)
            s = _tile_scores(kr, qt, None, torch.from_numpy(keys), queries + S - Tq, scale, False)
            if br is not None:
                s = s + br[:, None, :, None]
            if causal:
                s = torch.where(torch.from_numpy(keys)[:, None] > (S - Tq) + queries[None, :], torch.tensor(NEG_BIG), s)
            p = torch.exp(s - lt)
            ds = p * (torch.einsum("bhkd,bhqd->bhkq", vr, dot) - dt)
            col = torch.arange(bn)[None, :]
            use = (col // SIDE >= dead[warp][:, None]) & valid[None, :]
            use &= (col >= qq_begin[warp][:, None]) & (col < qq_end[warp][:, None])
            acc_v = acc_v + torch.einsum("bhkq,bhqd->bhkd", torch.where(use, p, 0.0), dot)
            acc_k = acc_k + torch.einsum("bhkq,bhqd->bhkd", torch.where(use, ds, 0.0), qt)
        dk[:, :, keys], dv[:, :, keys] = acc_k * scale, acc_v
    return dk.to(k.dtype), dv.to(v.dtype)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)


def _case(Tq, S, Dh, n_pad, seed, B=2, H=2, pad="left"):
    """f32 q, k, v, dO from numpy, a bias with batch row 1 padded (its first
    n_pad keys, or its last n_pad), the plain forward's out and lse, a
    cotangent zero on fully masked rows; as torch and JAX arrays."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Tq, Dh), np.float32)
    k, v = (rng.standard_normal((B, H, S, Dh), np.float32) for _ in range(2))
    bias = np.zeros((B, S), np.float32)
    if pad == "left":
        bias[1, :n_pad] = NEG_BIG
    else:
        bias[1, S - n_pad:] = NEG_BIG
    rows = np.ones((B, Tq), bool)
    if pad == "left":
        rows[1] = (np.arange(Tq) + S - Tq) >= n_pad
    g = rng.standard_normal((B, H, Tq, Dh), np.float32) * rows[:, None, :, None]
    scale = 1.0 / Dh**0.5
    tq, tk, tv, tb = (torch.from_numpy(a) for a in (q, k, v, bias))
    out, lse = tfa._plain_attention(tq, tk, tv, tb, True, scale)
    tg = torch.from_numpy(g)
    targs = (tq, tk, tv, tb, lse, tfa._delta(out, tg), tg)
    jargs = tuple(jnp.asarray(a) for a in (q, k, v, bias, out.numpy(), lse.numpy(), g))
    return targs, jargs, torch.from_numpy(rows), scale


def _excess(got, ref):
    return ((got - ref).abs() - GRAD_TOL[1] * ref.abs()).max().item()


# the dialog gates' head dims (oracle 32, buyer 48, policies 64) with ragged
# and right-aligned windows, and the wide instantiations
@pytest.mark.parametrize("Tq,S,Dh,n_pad,pad", [(256, 256, 32, 100, "left"), (200, 200, 48, 37, "right"),
                                                (160, 200, 64, 51, "left"), (65, 130, 64, 0, "left"),
                                                (129, 129, 64, 20, "right"), (17, 33, 128, 5, "left"),
                                                (40, 70, 256, 9, "left")])
def test_simt_arithmetic_matches_jax_backward(interpret, Tq, S, Dh, n_pad, pad):
    targs, jargs, _, scale = _case(Tq, S, Dh, n_pad, seed=Tq + S + Dh, pad=pad)
    jq, jk, jv, jb, jout, jlse, jg = jargs
    jdq, jdk, jdv = (torch.from_numpy(np.array(a)) for a in
                     jfa._flash_backward(jq, jk, jv, jb, jout, jlse, jg, True, scale, 64, 64)[:3])
    dq = simt_dq_emulation(*targs, scale)
    dk, dv = simt_dkv_emulation(*targs, scale)
    ref_dq = tfa._plain_bwd_dq(*targs, True, scale)
    ref_dk, ref_dv = tfa._plain_bwd_dkv(*targs, True, scale)
    for got, jref, pref in ((dq, jdq, ref_dq), (dk, jdk, ref_dk), (dv, jdv, ref_dv)):
        assert got.shape == pref.shape and got.dtype == torch.float32
        assert _excess(got, jref) <= GRAD_TOL[0]  # the JAX Pallas kernels
        assert _excess(got, pref) <= GRAD_TOL[0]  # the plain versions, as on the card
        assert torch.isfinite(got).all()


@pytest.mark.parametrize("Tq,S,Dh", [(768, 768, 64), (448, 448, 64), (512, 512, 48)])
def test_simt_arithmetic_at_the_dialog_windows(Tq, S, Dh):
    """The f32 dialog train windows (20Q policy 768, Car-Dealer 448, buyer
    512; right-padded), against the port's plain versions."""
    targs, _, _, scale = _case(Tq, S, Dh, n_pad=S // 3, seed=Tq, B=2, H=1, pad="right")
    dq = simt_dq_emulation(*targs, scale)
    dk, dv = simt_dkv_emulation(*targs, scale)
    assert _excess(dq, tfa._plain_bwd_dq(*targs, True, scale)) <= GRAD_TOL[0]
    for got, ref in zip((dk, dv), tfa._plain_bwd_dkv(*targs, True, scale)):
        assert _excess(got, ref) <= GRAD_TOL[0]


def test_simt_arithmetic_without_causal_mask():
    targs, _, _, _ = _case(70, 150, 32, 0, seed=5)
    dq = simt_dq_emulation(*targs, 0.2, causal=False)
    dk, dv = simt_dkv_emulation(*targs, 0.2, causal=False)
    assert _excess(dq, tfa._plain_bwd_dq(*targs, False, 0.2)) <= GRAD_TOL[0]
    for got, ref in zip((dk, dv), tfa._plain_bwd_dkv(*targs, False, 0.2)):
        assert _excess(got, ref) <= GRAD_TOL[0]


# ---- (c) fully masked rows ----------------------------------------------------

@pytest.mark.parametrize("Tq,S,n_pad", [(256, 256, 100), (10, 128, 125), (64, 64, 64), (37, 100, 100)])
def test_fully_masked_rows_read_p_one_and_pass_no_gradient(interpret, Tq, S, n_pad):
    targs, jargs, rows, scale = _case(Tq, S, 32, n_pad, seed=9)
    assert not rows.all()
    lse = targs[4]
    dead = ~rows[:, None, :].expand_as(lse)
    assert (lse[dead] == torch.tensor(NEG_BIG, dtype=torch.float32)).all()
    record = []
    dq = simt_dq_emulation(*targs, scale, record=record)
    dk, dv = simt_dkv_emulation(*targs, scale)
    for row_ids, _, p in record:  # P on the computed pairs of fully masked rows reads 1
        masked = ~rows[:, torch.from_numpy(row_ids)]
        p_dead = p[masked[:, None, :].expand(-1, p.shape[1], -1)]
        assert ((p_dead == 1.0) | p_dead.isnan()).all()
    assert (dq[dead[..., None].expand_as(dq)] == 0).all()
    jq, jk, jv, jb, jout, jlse, jg = jargs
    jdk, jdv = (torch.from_numpy(np.array(a)) for a in
                jfa._flash_backward(jq, jk, jv, jb, jout, jlse, jg, True, scale, 64, 64)[1:3])
    ref_dk, ref_dv = tfa._plain_bwd_dkv(*targs, True, scale)
    for got, jref, pref in ((dk, jdk, ref_dk), (dv, jdv, ref_dv)):
        assert _excess(got, jref) <= GRAD_TOL[0] and _excess(got, pref) <= GRAD_TOL[0]


# ---- (d) the route and its alignment rule -----------------------------------

@pytest.mark.parametrize("head_dim", [8, 24, 32, 40, 48, 64, 72, 128, 144, 256])
def test_f32_and_odd_bf16_take_the_cuda_core_backward(head_dim):
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert tfa._variant(torch.float32, head_dim, name) == "simt"
        assert tfa._variant(torch.bfloat16, head_dim, name) == ("tc" if head_dim % 16 == 0 else "simt")


@pytest.mark.parametrize("case", ["shifted start", "row stride 68", "shifted dout"])
@pytest.mark.parametrize("name", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_f32_backward_refuses_misaligned_inputs(case, name):
    """The CUDA-core backward copies 16-byte rows: `_launch` refuses a q (or
    a dO) that starts 4 bytes into its buffer, or whose rows are 68
    elements apart, before any launch and with nothing to fall back to."""
    B, H, T, Dh = 1, 2, 16, 64
    q = k = v = dout = torch.zeros(B, H, T, Dh)
    if case == "shifted start":
        q = torch.zeros(B * H * T * Dh + 1)[1:].view(B, H, T, Dh)
    elif case == "row stride 68":
        q = torch.zeros(B, H, T, Dh + 4)[..., :Dh]
    else:
        dout = torch.zeros(B * H * T * Dh + 1)[1:].view(B, H, T, Dh)
    assert tfa._variant(torch.float32, Dh, name) == "simt"
    lse = delta = torch.zeros(B, H, T)
    grads = {"flash_bwd_dq": dict(dq=torch.zeros(B, H, T, Dh)),
             "flash_bwd_dkv": dict(dk=torch.zeros(B, H, T, Dh), dv=torch.zeros(B, H, T, Dh))}[name]
    wrapper = getattr(tfa, name)
    before = wrapper.launches
    with pytest.raises(ValueError):
        tfa._launch(wrapper, name, (q, k, v, dout, None, lse, delta, *grads.values()),
                    dict(q=q, k=k, v=v, dout=dout, **grads), q, k, None, True, 0.125)
    assert wrapper.launches == before
