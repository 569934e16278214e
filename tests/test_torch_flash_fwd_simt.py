"""The CUDA-core forward kernel (`csrc/flash_fwd.cu`, K1's f32 route), on the CPU.

The kernel runs only on the card (tests/test_torch_kernels.py and
chip_smoke.py hold it to its plain version there). What is checked here:

(a) The tile schedule: a mirror of the kernel's index arithmetic (which
    (b, h, 64-row query tile) each block owns, in the order the blocks
    take them; which key tiles it loads up to `kv_end`; which of its 256
    threads owns each score: thread (tr, tc) scores rows 4 tr + i against
    keys tc + 16 j of each tile; which 16-key blocks a warp skips on the
    causal diagonal) against a brute-force causal mask over a grid of
    (Tq, S) with right-aligned queries and Dh ∈ {32, 48, 64, 128, 256}
    (64-key tiles up to Dh = 64, 32-key tiles above): every visible pair is
    weighted exactly once, by exactly one thread, and no skipped key is
    visible to a row of its warp.
(b) The kernel's arithmetic, emulated in PyTorch in f32 over the mirrored
    schedule (scores from Q scaled once, bias and masks in f32, an online
    softmax over the block's key tiles from m = −0.7·f32max, each thread's
    share of the row sum rescaled with the row and summed at the end),
    against the JAX package's `_flash_forward` in f32 (its Pallas kernel in
    interpret mode) and against the port's plain version, at the f32 TOL
    of chip_smoke.py (1e-4 on out, summation order only) and 1e-4 on lse;
    at T = 768 against `_xla_attention`.
(c) Fully masked (left-pad) query rows keep lse = −0.7·f32max exactly.
(d) The wrapper's 16-byte rule on the f32 forward's inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lmrl_gym_tpu.ops.flash_attention as jfa
from lmrl_gym_torch.ops import flash_attention as tfa

NEG_BIG = -0.7 * float(np.finfo(np.float32).max)
TOL = 1e-4  # f32 atol on out (rtol 0), as chip_smoke.py and tests/test_torch_kernels.py
LSE_TOL = 1e-4

BQ, GRID_SIDE = 64, 16  # query rows per block; the 16 x 16 thread grid
ROWS_PER = BQ // GRID_SIDE  # query rows per thread


def key_tile(head_dim: int) -> int:
    """Keys per tile of the instantiation `dispatch` picks for Dh."""
    return 64 if head_dim <= 64 else 32


# ---- (a) the tile schedule -------------------------------------------------

def schedule(Tq, S, head_dim, causal=True):
    """Mirror of flash_fwd's launch and kernel index arithmetic for one (b, h):
    one entry per block in launch order (blockIdx.x), with its first query
    row q0, kv_end and the number of key tiles it loads."""
    bk = key_tile(head_dim)
    n_qt = (Tq + BQ - 1) // BQ
    blocks = []
    for bx in range(n_qt):
        q0 = (n_qt - 1 - bx) * BQ  # the longest key ranges first
        q_last = min(q0 + BQ, Tq) - 1
        kv_end = min(S, (S - Tq) + q_last + 1) if causal else S
        blocks.append(dict(q0=q0, kv_end=kv_end, n_tiles=(kv_end + bk - 1) // bk, bk=bk))
    return blocks


def live_blocks(blk, tid, t, Tq, S, causal=True):
    """How many of tile t's 16-key blocks the warp of thread `tid` scores:
    under the causal mask, the blocks up to its last query position (warp
    w owns rows 8 w .. 8 w + 7)."""
    kj = blk["bk"] // GRID_SIDE
    if not causal:
        return kj
    warp_last = (S - Tq) + blk["q0"] + 8 * (tid // 32) + 7
    j0 = t * blk["bk"]
    return 0 if warp_last < j0 else min(kj, (warp_last - j0) // GRID_SIDE + 1)


def thread_pairs(blk, tid, Tq, S, causal=True):
    """The (row, key) pairs thread `tid` holds over the block's tiles, as
    index arrays (rows past Tq and keys past kv_end included), and whether
    the thread computes each pair's product (False: a skipped key block)."""
    tr, tc = tid // GRID_SIDE, tid % GRID_SIDE
    rows = blk["q0"] + ROWS_PER * tr + np.arange(ROWS_PER)
    kj = blk["bk"] // GRID_SIDE
    keys, computed = [], []
    for t in range(blk["n_tiles"]):
        keys.append(t * blk["bk"] + tc + GRID_SIDE * np.arange(kj))
        computed.append(np.arange(kj) < live_blocks(blk, tid, t, Tq, S, causal))
    keys, computed = np.concatenate(keys), np.concatenate(computed)
    return np.repeat(rows, len(keys)), np.tile(keys, len(rows)), np.tile(computed, len(rows))


def score_kind(rows, keys, kv_end, Tq, S, causal=True):
    """Per pair the score the kernel gives: 0 a real score, 1 the masked
    value −0.7·f32max, 2 −inf (past the block's causal limit: weight 0)."""
    kind = np.zeros(len(rows), int)
    if causal:
        kind[keys > (S - Tq) + rows] = 1
    kind[keys >= kv_end] = 2
    return kind


GRID = [(1, 1), (1, 40), (8, 8), (10, 128), (16, 16), (37, 100), (63, 64), (64, 64), (65, 65), (65, 200),
        (100, 100), (129, 130), (160, 160), (200, 264), (256, 256)]


@pytest.mark.parametrize("head_dim", [32, 48, 64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_tile_schedule_matches_causal_mask(head_dim, causal):
    for Tq, S in GRID:
        vis = ((np.arange(Tq)[:, None] + (S - Tq)) >= np.arange(S)[None, :]) if causal else np.ones((Tq, S), bool)
        owner = np.zeros((Tq, S), int)  # threads that weight each (query, key) pair
        row_blocks = np.zeros(Tq, int)
        blocks = schedule(Tq, S, head_dim, causal)
        assert [b["q0"] for b in blocks] == sorted((b["q0"] for b in blocks), reverse=True)
        for blk in blocks:
            assert blk["kv_end"] <= S and (blk["n_tiles"] - 1) * blk["bk"] < blk["kv_end"]  # no tile wholly past it
            live_rows = np.arange(blk["q0"], min(blk["q0"] + BQ, Tq))
            row_blocks[live_rows] += 1
            # the block loads every key that a live row of it sees
            assert not vis[np.ix_(live_rows, np.arange(blk["kv_end"], S))].any(), (Tq, S, blk)
            block_pairs = set()
            for tid in range(GRID_SIDE * GRID_SIDE):
                rows, keys, computed = thread_pairs(blk, tid, Tq, S, causal)
                pairs = set(zip(rows.tolist(), keys.tolist()))
                assert not pairs & block_pairs  # no two threads of a block score one pair
                block_pairs |= pairs
                kind = score_kind(rows, keys, blk["kv_end"], Tq, S, causal)
                assert (kind[~computed] != 0).all()  # a skipped key is masked (or past kv_end) for the warp's rows
                real = (kind == 0) & (rows < Tq) & (keys < S)
                assert vis[rows[real], keys[real]].all()  # a real score is a visible pair
                np.add.at(owner, (rows[real], keys[real]), 1)
            # the block's threads cover its 64 rows x every loaded key
            assert len(block_pairs) == BQ * blk["n_tiles"] * blk["bk"]
        assert (row_blocks == 1).all()  # every query row belongs to exactly one block
        assert (owner == vis).all(), (Tq, S)  # every visible pair weighted exactly once


# ---- (b) the arithmetic -----------------------------------------------------

def simt_forward_emulation(q, k, v, bias, scale, causal=True):
    """flash_fwd.cu's arithmetic over the mirrored schedule, f32: per block,
    Q·scale once; per key tile s = Q·Kᵀ + bias, masked keys −0.7·f32max,
    keys past kv_end −inf; m from −0.7·f32max, alpha = exp(m − m_new),
    P = exp(s − m_new); each thread's share of the row sum (keys tc + 16 j)
    rescaled with the row and summed over the 16 threads at the end;
    out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30))."""
    B, H, Tq, Dh = q.shape
    S = k.shape[2]
    out = torch.zeros(B, H, Tq, Dh)
    lse = torch.zeros(B, H, Tq)
    b_row = bias.float() if bias is not None else None
    for blk in schedule(Tq, S, Dh, causal):
        rows = np.arange(blk["q0"], min(blk["q0"] + BQ, Tq))
        qs = q[:, :, rows].float() * scale
        q_pos = torch.from_numpy((S - Tq) + rows)
        m = torch.full((B, H, len(rows)), NEG_BIG)
        l_part = torch.zeros(B, H, len(rows), GRID_SIDE)  # per thread column tc
        acc = torch.zeros(B, H, len(rows), Dh)
        bk = blk["bk"]
        for t in range(blk["n_tiles"]):
            keys = torch.arange(t * bk, (t + 1) * bk)
            live = keys < blk["kv_end"]
            idx = keys.clamp(max=S - 1)
            kt = torch.where(live[:, None], k[:, :, idx].float(), 0.0)
            vt = torch.where(live[:, None], v[:, :, idx].float(), 0.0)
            s = torch.einsum("bhqd,bhkd->bhqk", qs, kt)
            if b_row is not None:
                s = s + torch.where(live, b_row[:, idx], 0.0)[:, None, None]
            if causal:
                s = torch.where(keys[None, :] > q_pos[:, None], torch.tensor(NEG_BIG), s)
            s = torch.where(live, s, torch.tensor(-float("inf")))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            # key tc + 16 j of the tile belongs to thread column tc
            l_part = l_part * alpha[..., None] + p.reshape(B, H, len(rows), bk // GRID_SIDE, GRID_SIDE).sum(-2)
            acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vt)
            m = m_new
        lc = l_part.sum(-1).clamp(min=1e-30)
        out[:, :, rows] = acc / lc[..., None]
        lse[:, :, rows] = m + torch.log(lc)
    return out.to(q.dtype), lse


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)


def _case(Tq, S, Dh, n_pad, seed, B=2, H=2):
    """f32 q, k, v from numpy (as JAX and torch arrays), the bias with batch
    row 1's first n_pad keys masked, and the [B, Tq] rows that see a key."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Tq, Dh), np.float32)
    k, v = (rng.standard_normal((B, H, S, Dh), np.float32) for _ in range(2))
    bias = np.zeros((B, S), np.float32)
    bias[1, :n_pad] = NEG_BIG
    rows = np.ones((B, Tq), bool)
    rows[1] = (np.arange(Tq) + S - Tq) >= n_pad
    jargs = tuple(jnp.asarray(a) for a in (q, k, v, bias))
    targs = tuple(torch.from_numpy(a) for a in (q, k, v, bias))
    return jargs, targs, torch.from_numpy(rows)


def _excess(got, ref, rows):
    return (got - ref).abs().amax(dim=(1, 3))[rows].max().item()


# the dialog gates' head dims (oracle 32, buyer 48, policies 64) at the
# oracle's 256-token windows, with prefills right-aligned over cached keys
@pytest.mark.parametrize("Tq,S,Dh,n_pad", [(256, 256, 32, 0), (256, 256, 32, 100), (200, 200, 48, 37),
                                           (160, 200, 64, 51), (65, 130, 64, 0), (17, 33, 128, 5)])
def test_simt_arithmetic_matches_jax_forward(interpret, Tq, S, Dh, n_pad):
    scale = 1.0 / Dh**0.5
    jargs, targs, rows = _case(Tq, S, Dh, n_pad, seed=Tq + S + Dh)
    jout, jlse = jfa._flash_forward(*jargs, True, scale, 64, 64)
    jout, jlse = torch.from_numpy(np.array(jout)), torch.from_numpy(np.array(jlse))
    out, lse = simt_forward_emulation(*targs, scale)
    ref, ref_lse = tfa._plain_attention(*targs, True, scale)
    assert out.shape == ref.shape and out.dtype == ref.dtype == torch.float32
    live = rows[:, None, :].expand_as(lse)
    for other, other_lse in ((jout, jlse), (ref, ref_lse)):  # the JAX Pallas kernel; the plain version on the card
        assert _excess(out, other, rows) <= TOL
        assert (lse - other_lse).abs()[live].max().item() <= LSE_TOL
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()


def test_simt_arithmetic_at_the_dialog_window():
    """T = 768 (the 20Q policy's windows and prefills), left-padded, against
    the JAX package's XLA attention and the port's plain version."""
    Tq = S = 768
    Dh, scale = 64, 1.0 / 64**0.5
    jargs, targs, rows = _case(Tq, S, Dh, n_pad=300, seed=768, B=2, H=1)
    jout = torch.from_numpy(np.array(jfa._xla_attention(*jargs, True, scale)))
    out, lse = simt_forward_emulation(*targs, scale)
    ref, ref_lse = tfa._plain_attention(*targs, True, scale)
    assert _excess(out, jout, rows) <= TOL
    assert _excess(out, ref, rows) <= TOL
    assert (lse - ref_lse).abs()[rows[:, None, :]].max().item() <= LSE_TOL


def test_simt_arithmetic_without_causal_mask():
    Tq, S, Dh = 70, 150, 32
    _, targs, _ = _case(Tq, S, Dh, n_pad=0, seed=5)
    out, lse = simt_forward_emulation(*targs, 0.2, causal=False)
    ref, ref_lse = tfa._plain_attention(*targs, False, 0.2)
    assert (out - ref).abs().max().item() <= TOL
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL


# ---- (c) left-pad rows ------------------------------------------------------

@pytest.mark.parametrize("Tq,S,n_pad", [(256, 256, 100), (10, 128, 125), (64, 64, 64), (37, 100, 100)])
def test_left_pad_rows_keep_neg_big_lse(interpret, Tq, S, n_pad):
    """Query rows whose every key is masked: lse = −0.7·f32max exactly, in
    the emulation as in the JAX kernel and the plain version, never −inf or
    NaN; the backward kernels read it as P = 1."""
    scale = 1.0 / 32**0.5
    jargs, targs, rows = _case(Tq, S, 32, n_pad, seed=9)
    assert not rows.all()
    _, jlse = jfa._flash_forward(*jargs, True, scale, 64, 64)
    out, lse = simt_forward_emulation(*targs, scale)
    _, ref_lse = tfa._plain_attention(*targs, True, scale)
    dead = (~rows)[:, None, :].expand_as(lse)
    neg_big = torch.tensor(NEG_BIG, dtype=torch.float32)
    for got in (lse, torch.from_numpy(np.array(jlse)), ref_lse):
        assert (got[dead] == neg_big).all()
    assert torch.isfinite(out).all()


# ---- (d) alignment ------------------------------------------------------------

@pytest.mark.parametrize("case", ["shifted start", "row stride 68"])
def test_f32_forward_refuses_misaligned_inputs(case):
    """The f32 forward copies 16-byte rows: `_launch` refuses a q that starts
    4 bytes into its buffer or whose rows are 68 elements apart, before any
    launch and with nothing to fall back to."""
    B, H, T, Dh = 1, 2, 16, 64
    k = v = torch.zeros(B, H, T, Dh)
    if case == "shifted start":
        q = torch.zeros(B * H * T * Dh + 1)[1:].view(B, H, T, Dh)
    else:
        q = torch.zeros(B, H, T, Dh + 4)[..., :Dh]
    out = torch.zeros(B, T, H, Dh).permute(0, 2, 1, 3)
    assert tfa._variant(torch.float32, Dh, "flash_fwd") == "simt"
    before = tfa.flash_fwd.launches
    with pytest.raises(ValueError):
        tfa._launch(tfa.flash_fwd, "flash_fwd", (q, k, v, None, out, torch.zeros(B, H, T)),
                    dict(q=q, k=k, v=v, out=out), q, k, None, True, 0.125)
    assert tfa.flash_fwd.launches == before
