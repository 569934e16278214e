"""The tensor-core forward kernel (`csrc/flash_fwd_tc.cu`, K1), on the CPU.

The kernel runs only on the card (tests/test_torch_kernels.py holds it to
its plain version there). What is checked here:

(a) `_variant`: which forward kernel takes each (dtype, head dim).
(b) The tile schedule of both block shapes: a mirror of the kernel's index
    arithmetic (which (b, h) and query rows each warp owns, which key tiles
    its stream loads up to `kv_end`, which of them the warp computes on, and
    the score each (query, key) pair gets) against a brute-force causal
    mask, over a grid of (Tq, S): every visible pair is weighted exactly
    once, and no live row weights a key past its limit.
(c) The kernel's arithmetic, emulated in PyTorch over the mirrored schedule
    — bf16 operands, f32 products and sums, an online softmax over the
    kernel's key tiles, P rounded to bf16 before P·V — against the JAX
    package's `_flash_forward` on bf16 inputs (its Pallas kernel in
    interpret mode) and against the port's plain version, within
    chip_smoke.py's bf16 TOL on out and 1e-3 on lse. One bf16 rounding of
    P is a relative error ≤ 2⁻⁹ per term of a convex combination, well
    inside the tolerance's 2⁻⁶ relative; the row sums take P in f32, so lse
    does not see the rounding.
(c′) Fully masked (left-pad) query rows: lse is −0.7·f32max exactly, in the
    emulation as in the JAX kernel, which the backward reads as P = 1.
(d) The 16-byte alignment rule the tensor-core wrapper enforces on q, k, v.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lmrl_gym_tpu.ops.flash_attention as jfa
from lmrl_gym_torch.ops import flash_attention as tfa

NEG_BIG = -0.7 * float(np.finfo(np.float32).max)
TOL = (1e-2, 2.0**-6)  # bf16 (atol, rtol) on out, as chip_smoke.py and tests/test_torch_kernels.py
LSE_TOL = 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [16, 24, 32, 48, 64, 128, 256])
def test_variant_choice(dtype, head_dim):
    """bf16 with Dh a multiple of 16 up to 128 takes the tensor cores, in
    both directions; f32 (TF32 is off), Dh = 24 (not whole k16 steps) and
    Dh = 256 keep the fp32 CUDA-core kernels."""
    want = "tc" if dtype == torch.bfloat16 and head_dim % 16 == 0 and head_dim <= 128 else "simt"
    assert tfa._variant(dtype, head_dim) == want


# ---- (b) the tile schedule -------------------------------------------------

ROWS = 16  # query rows of one warp (kRows)
# (warps per block, keys per streamed tile) of `launch`'s two block shapes,
# the same for every head dim
SHARED_WARPS, SHARED_BK = 4, 32  # Tq > 16: 64 query rows per block
OWN_WARPS, OWN_BK = 2, 16  # Tq <= 16: one (b, h) per warp


def schedule(B, H, Tq, S, causal=True):
    """Mirror of flash_fwd_tc's launch and kernel index arithmetic: one
    entry per warp that runs, with its (b, h), first query row q0, the
    stream's kv_end, the tile size and the key tiles it computes on."""
    offset = S - Tq
    shared = Tq > ROWS
    bk = SHARED_BK if shared else OWN_BK
    warps = []

    def add(b, h, q0, rows_end):
        kv_end = min(S, offset + rows_end) if causal else S
        n_tiles = (kv_end + bk - 1) // bk
        warp_end = 0 if q0 >= Tq else (min(S, offset + min(q0 + ROWS, Tq)) if causal else S)
        tiles = [it for it in range(n_tiles) if it * bk < warp_end]
        warps.append(dict(b=b, h=h, q0=q0, kv_end=kv_end, n_tiles=n_tiles, bk=bk, tiles=tiles))

    if shared:  # grid (ceil(Tq / 64), H, B), warps of a block share the stream
        block_rows = SHARED_WARPS * ROWS
        for b in range(B):
            for h in range(H):
                for qt in range((Tq + block_rows - 1) // block_rows):
                    rows_end = min((qt + 1) * block_rows, Tq)
                    for w in range(SHARED_WARPS):
                        add(b, h, qt * block_rows + w * ROWS, rows_end)
    else:  # grid ceil(B·H / 2), one (b, h) per warp
        for bx in range((B * H + OWN_WARPS - 1) // OWN_WARPS):
            for w in range(OWN_WARPS):
                bh = bx * OWN_WARPS + w
                if bh < B * H:
                    add(bh // H, bh % H, 0, Tq)
    return warps


def visible(Tq, S):
    """[Tq, S] causal mask, queries right-aligned at offset S − Tq."""
    return (np.arange(Tq)[:, None] + (S - Tq)) >= np.arange(S)[None, :]


def tile_scores(w, Tq, S, causal=True):
    """For warp `w`: its live rows, the keys of the tiles it computes on,
    and per (row, key) the kind of score the kernel gives: 0 a real score,
    1 the masked value −0.7·f32max, 2 −inf (past the stream's end: zero
    filled, weight exactly 0)."""
    rows = np.arange(w["q0"], w["q0"] + ROWS)
    rows = rows[rows < Tq]
    bk = w["bk"]
    keys = np.concatenate([np.arange(it * bk, (it + 1) * bk) for it in w["tiles"]] or [np.zeros(0, int)])
    kind = np.zeros((len(rows), len(keys)), int)
    if causal:
        kind[keys[None, :] > (S - Tq) + rows[:, None]] = 1
    kind[:, keys >= w["kv_end"]] = 2
    return rows, keys, kind


GRID = [(1, 40), (8, 8), (10, 28), (10, 48), (10, 68), (10, 88), (10, 108), (10, 128), (16, 16), (17, 17),
        (37, 100), (64, 64), (65, 200), (129, 130), (160, 160)]


@pytest.mark.parametrize("Tq,S", GRID)
@pytest.mark.parametrize("B,H", [(1, 5), (2, 3)])
def test_tile_schedule_matches_causal_mask(Tq, S, B, H):
    """B·H = 5: the per-warp grid's last block has an idle warp."""
    vis = visible(Tq, S)
    owned = np.zeros((B, H, Tq), int)
    weighted = np.zeros((B, H, Tq, S), int)
    for w in schedule(B, H, Tq, S):
        rows, keys, kind = tile_scores(w, Tq, S)
        owned[w["b"], w["h"], rows] += 1
        assert w["kv_end"] <= S  # keys past S are zero-filled and score -inf
        # the stream stops at the causal limit of its last live query
        first = w["q0"] - w["q0"] % (SHARED_WARPS * ROWS)  # the stream's first row (0 for Tq <= 16)
        last_live = min(S, (S - Tq) + min(Tq, first + SHARED_WARPS * ROWS))
        assert w["kv_end"] == last_live, (Tq, S, w)
        assert (w["n_tiles"] - 1) * w["bk"] < w["kv_end"]  # no tile wholly past it
        real = kind == 0
        assert vis[np.ix_(rows, keys[keys < S])][real[:, keys < S]].all(), (Tq, S, w)  # no live row weights a key past its limit
        assert not real[:, keys >= S].any()
        # a tile the warp skips holds no visible key of its rows
        skipped = [it for it in range(w["n_tiles"]) if it not in w["tiles"]]
        for it in skipped:
            assert not vis[np.ix_(rows, np.arange(it * w["bk"], min((it + 1) * w["bk"], S)))].any()
        k_in = keys < S
        weighted[w["b"], w["h"]][np.ix_(rows, keys[k_in])] += real[:, k_in]
    assert (owned == 1).all()  # every query row belongs to exactly one warp
    assert (weighted == vis[None, None]).all()  # every visible pair weighted exactly once


# ---- (c) the arithmetic -----------------------------------------------------

def tc_forward_emulation(q, k, v, bias, scale):
    """The tensor-core forward's arithmetic over the mirrored schedule:
    S = Q·Kᵀ from bf16 operands with f32 products and sums; scale, bias and
    masks in f32 (−inf past the stream's end, −0.7·f32max for a masked
    key); an online softmax over the warp's key tiles from m = −0.7·f32max,
    exp(s − m), row sums of P in f32; P rounded to bf16 before P·V; out
    rounded to bf16. → (out bf16, lse f32)."""
    B, H, Tq, Dh = q.shape
    S = k.shape[2]
    out = torch.zeros(B, H, Tq, Dh, dtype=torch.bfloat16)
    lse = torch.zeros(B, H, Tq)
    b_row = bias.float() if bias is not None else torch.zeros(B, S)
    for w in schedule(1, 1, Tq, S):  # the same for every (b, h)
        rows, keys, kind = tile_scores(w, Tq, S)
        if len(rows) == 0:
            continue
        qr = q[:, :, rows].float()
        m = torch.full((B, H, len(rows)), NEG_BIG)
        l = torch.zeros(B, H, len(rows))
        acc = torch.zeros(B, H, len(rows), Dh)
        for t, it in enumerate(w["tiles"]):
            cols = slice(t * w["bk"], (t + 1) * w["bk"])
            tk, kd = keys[cols], torch.from_numpy(kind[:, cols])
            live = torch.from_numpy(tk < w["kv_end"])
            idx = torch.from_numpy(np.minimum(tk, S - 1))
            kt = torch.where(live[:, None], k[:, :, idx].float(), 0.0)
            vt = torch.where(live[:, None], v[:, :, idx].float(), 0.0)
            s = torch.einsum("bhqd,bhkd->bhqk", qr, kt) * scale + torch.where(live, b_row[:, idx], 0.0)[:, None, None]
            s = torch.where(kd == 1, torch.tensor(NEG_BIG), s)
            s = torch.where(kd == 2, torch.tensor(-float("inf")), s)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vt)
            m = m_new
        lc = l.clamp(min=1e-30)
        out[:, :, rows] = (acc / lc[..., None]).to(torch.bfloat16)
        lse[:, :, rows] = m + torch.log(lc)
    return out, lse


def excess(got, ref):
    return ((got.float() - ref.float()).abs() - TOL[1] * ref.float().abs()).amax(dim=(1, 3))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)


def _case(Tq, S, n_pad, seed, B=2, H=2, Dh=64):
    """bf16 q, k, v from numpy (as JAX and torch arrays), the f32 bias with
    batch 1's first n_pad keys masked, and the [B, Tq] rows that see a
    key."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Tq, Dh), np.float32)
    k, v = (rng.standard_normal((B, H, S, Dh), np.float32) for _ in range(2))
    bias = np.zeros((B, S), np.float32)
    bias[1, :n_pad] = NEG_BIG
    rows = np.ones((B, Tq), bool)
    rows[1] = (np.arange(Tq) + S - Tq) >= n_pad
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(torch.bfloat16) for a in (jq, jk, jv))
    return (jq, jk, jv, jnp.asarray(bias)), (tq, tk, tv, torch.from_numpy(bias)), torch.from_numpy(rows)


@pytest.mark.parametrize("Tq,S,n_pad,bq,bk", [(10, 128, 0, 16, 32), (160, 160, 37, 32, 32), (37, 100, 0, 16, 32),
                                              (16, 16, 5, 16, 16)])
def test_tc_arithmetic_matches_jax_forward(interpret, Tq, S, n_pad, bq, bk):
    scale = 1.0 / 64**0.5
    jargs, targs, rows = _case(Tq, S, n_pad, seed=Tq + S)
    jout, jlse = jfa._flash_forward(*jargs, True, scale, bq, bk)
    jout = torch.from_numpy(np.array(jnp.asarray(jout, jnp.float32)))
    jlse = torch.from_numpy(np.array(jlse))
    out, lse = tc_forward_emulation(*targs, scale)
    ref, ref_lse = tfa._plain_attention(*targs, True, scale)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    live = rows[:, None, :].expand_as(lse)
    for other, other_lse in ((jout, jlse), (ref, ref_lse)):  # the JAX Pallas kernel; the plain version on the card
        assert excess(out, other)[rows].max().item() <= TOL[0]
        assert (lse - other_lse).abs()[live].max().item() <= LSE_TOL
    assert excess(ref, jout)[rows].max().item() <= TOL[0]
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()


@pytest.mark.parametrize("Tq,S,n_pad", [(160, 160, 37), (10, 128, 125), (16, 16, 16)])
def test_left_pad_rows_keep_neg_big_lse(interpret, Tq, S, n_pad):
    """Query rows whose every key is masked: lse = −0.7·f32max exactly, as
    the JAX kernel and the plain version give it, never −inf or NaN."""
    scale = 1.0 / 64**0.5
    jargs, targs, rows = _case(Tq, S, n_pad, seed=7)
    assert not rows.all()
    _, jlse = jfa._flash_forward(*jargs, True, scale, 16, 16)
    _, lse = tc_forward_emulation(*targs, scale)
    _, ref_lse = tfa._plain_attention(*targs, True, scale)
    dead = (~rows)[:, None, :].expand_as(lse)
    neg_big = torch.tensor(NEG_BIG, dtype=torch.float32)
    for got in (lse, torch.from_numpy(np.array(jlse)), ref_lse):
        assert (got[dead] == neg_big).all()


def test_past_end_keys_take_no_weight():
    """Tq = 10 over S = 28: the last 32-key tile holds 4 zero-filled keys
    past S. They score −inf, not −0.7·f32max: a fully masked row spreads
    its weight over the real keys only (so does the plain version, whose
    scores stop at S), and a zero key never takes weight from a live row."""
    Tq, S = 10, 28
    _, (q, k, v, bias), _ = _case(Tq, S, n_pad=S, seed=3)  # batch 1: every key masked
    out, lse = tc_forward_emulation(q, k, v, bias, 0.125)
    ref, _ = tfa._plain_attention(q, k, v, bias, True, 0.125)
    # batch 1, last row: every key scores −0.7·f32max, so P = 1 on the 28 real keys
    assert excess(out[1:, :, -1:], ref[1:, :, -1:]).max().item() <= TOL[0]
    assert (lse[1] == torch.tensor(NEG_BIG, dtype=torch.float32)).all()


# ---- (d) alignment ------------------------------------------------------------

def test_alignment_rule_takes_serving_views():
    """q as a view into the fused [B, T, 3, H, Dh] projection (row stride
    3·H·Dh), k/v as the filled prefix of a [B, H, T_max, Dh] cache."""
    B, T, H, Dh, T_max, index = 2, 10, 3, 64, 128, 30
    qkv = torch.zeros(B, T, 3, H, Dh, dtype=torch.bfloat16)
    cache = torch.zeros(B, H, T_max, Dh, dtype=torch.bfloat16)
    q = qkv[:, :, 0].transpose(1, 2)
    tfa._check_tc_alignment(q=q, k=cache[:, :, :index + T], v=cache[:, :, :index + T])


@pytest.mark.parametrize("case", ["shifted start", "row stride 68", "batch stride 4"])
def test_alignment_rule_refuses(case):
    B, H, T, Dh = 2, 2, 8, 64
    if case == "shifted start":
        t = torch.zeros(B * H * T * Dh + 1, dtype=torch.bfloat16)[1:].view(B, H, T, Dh)
    elif case == "row stride 68":
        t = torch.zeros(B, H, T, Dh + 4, dtype=torch.bfloat16)[..., :Dh]
    else:
        t = torch.zeros(4 * B * H * T * Dh, dtype=torch.bfloat16).as_strided((B, H, T, Dh), (4, T * Dh, Dh, 1))
    with pytest.raises(ValueError):
        tfa._check_tc_alignment(q=t)


def test_cpu_bf16_forward_takes_plain_path_and_counts_nothing():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 9, 64), np.float32)).to(torch.bfloat16) for _ in range(3))
    before = (tfa.flash_fwd.launches, tfa.flash_fwd.tc_launches)
    out, lse = tfa.flash_fwd(q, k, v)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert (tfa.flash_fwd.launches, tfa.flash_fwd.tc_launches) == before
