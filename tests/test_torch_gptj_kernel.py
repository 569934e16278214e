"""K1's and K4's Dh = 256 routes (GPT-J's head width), on the CPU.

The kernels run only on the card (tests/test_torch_kernels.py and
chip_smoke.py hold them to their plain versions there). What is checked
here:

(a) `_variant` at GPT-J's head width: bf16 Dh = 256 takes the tensor
    cores for the forward and both backward kernels (their wide kernels),
    f32 keeps the CUDA cores; the 16-byte alignment rule takes GPT-J's
    fused qkv and cache views and refuses misaligned strides. (The wide
    backward kernels' schedule and arithmetic: tests/
    test_torch_flash_bwd_tc.py.)
(b) The wide forward's tile schedule (`flash_fwd_tc_wide_kernel` in
    csrc/flash_fwd_tc.cu): a mirror of its index arithmetic for both block
    shapes — 64 query rows per 4-warp block for Tq > 16; one (b, h) per
    block, warp w owning output columns [64w, 64w + 64), for Tq ≤ 16 —
    against a brute-force causal mask: every visible (query, key) pair is
    weighted exactly once, and every output element has exactly one owner.
(c) Its arithmetic, emulated over the mirrored schedule (bf16 operands,
    f32 sums, an online softmax over 32-key tiles, P rounded to bf16
    before P·V), against the JAX package's `_flash_forward` on bf16 inputs
    (its Pallas kernel in interpret mode) and the port's plain version, at
    chip_smoke.py's bf16 TOL on out and 1e-3 on lse; fully masked rows keep
    lse = −0.7·f32max.
(d) K4's route for Dh > 128 at B·H below 1,024 (`decode_attn_wide_kernel`
    in csrc/decode_attn.cu; the rollout's B·H = 4,096 keeps the G = 32
    kernel): a mirror of which keys each of a block's 32 lane groups reads
    (every key 0..index exactly once), and its arithmetic — per-group
    online softmaxes merged with one weight per group — against the plain
    version in f32 (2e-5, summation order only).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lmrl_gym_tpu.ops.flash_attention as jfa
from lmrl_gym_torch.ops import decode_attention as tda
from lmrl_gym_torch.ops import flash_attention as tfa

NEG_BIG = -0.7 * float(np.finfo(np.float32).max)
TOL = (1e-2, 2.0**-6)  # bf16 (atol, rtol) on out, as chip_smoke.py
LSE_TOL = 1e-3
DH = 256


# ---- (a) the route ------------------------------------------------------------

@pytest.mark.parametrize("dtype,name,want", [
    (torch.bfloat16, "flash_fwd", "tc"), (torch.float32, "flash_fwd", "simt"),
    (torch.bfloat16, "flash_bwd_dq", "tc"), (torch.bfloat16, "flash_bwd_dkv", "tc"),
    (torch.float32, "flash_bwd_dq", "simt"), (torch.float32, "flash_bwd_dkv", "simt"),
])
def test_variant_at_gptj_head_dim(dtype, name, want):
    assert tfa._variant(dtype, DH, name) == want


def test_alignment_rule_takes_gptj_views():
    """GPT-J's trunk hands K1 q as a view into the fused [B, T, 3·H·Dh]
    projection after rotary (a fresh [B, H, T, Dh] tensor) or before it,
    and k/v as the filled prefix of a [B, H, T_max, 256] cache."""
    B, T, H, T_max, index = 2, 10, 16, 128, 30
    qkv = torch.zeros(B, T, 3 * H * DH, dtype=torch.bfloat16)
    q = qkv[..., : H * DH].view(B, T, H, DH).transpose(1, 2)
    cache = torch.zeros(B, H, T_max, DH, dtype=torch.bfloat16)
    tfa._check_tc_alignment(q=q, k=cache[:, :, :index + T], v=cache[:, :, :index + T])


@pytest.mark.parametrize("case", ["shifted start", "row stride 260", "head stride 4"])
def test_alignment_rule_refuses_at_gptj_head_dim(case):
    B, H, T = 2, 2, 8
    if case == "shifted start":
        t = torch.zeros(B * H * T * DH + 1, dtype=torch.bfloat16)[1:].view(B, H, T, DH)
    elif case == "row stride 260":
        t = torch.zeros(B, H, T, DH + 4, dtype=torch.bfloat16)[..., :DH]
    else:
        t = torch.zeros(B * T * DH + 8 * H, dtype=torch.bfloat16).as_strided((B, H, T, DH), (T * DH, 4, DH, 1))
    with pytest.raises(ValueError):
        tfa._check_tc_alignment(q=t)


# ---- (b) the wide forward's schedule -----------------------------------------

ROWS, WARPS, BK = 16, 4, 32  # rows of a warp's m16 tile, warps per block, keys per tile


def wide_schedule(Tq, S, causal=True):
    """Mirror of flash_fwd_tc_wide_kernel's index arithmetic for one (b, h):
    one entry per warp with its query rows, output columns, the stream's
    kv_end and the key tiles the warp computes on."""
    offset = S - Tq
    row_split = Tq > ROWS
    q_rows = WARPS * ROWS if row_split else ROWS
    cols = DH if row_split else DH // WARPS
    warps = []
    for qt in range((Tq + q_rows - 1) // q_rows if row_split else 1):
        q0 = qt * q_rows
        rows_end = min(q0 + q_rows, Tq)
        kv_end = min(S, offset + rows_end) if causal else S
        n_tiles = (kv_end + BK - 1) // BK
        for w in range(WARPS):
            wq0 = q0 + w * ROWS if row_split else 0
            c0 = 0 if row_split else w * cols
            warp_end = 0 if wq0 >= Tq else (min(S, offset + min(wq0 + ROWS, Tq)) if causal else S)
            tiles = [it for it in range(n_tiles) if it * BK < warp_end]
            rows = np.arange(wq0, min(wq0 + ROWS, Tq))
            warps.append(dict(rows=rows, cols=np.arange(c0, c0 + cols), kv_end=kv_end, n_tiles=n_tiles, tiles=tiles,
                              writes_lse=row_split or w == 0))
    return warps


def visible(Tq, S):
    return (np.arange(Tq)[:, None] + (S - Tq)) >= np.arange(S)[None, :]


GRID = [(1, 40), (8, 8), (10, 28), (10, 68), (10, 128), (16, 16), (17, 33), (37, 100), (64, 64), (65, 200),
        (129, 130), (640, 640)]


@pytest.mark.parametrize("Tq,S", GRID)
def test_wide_schedule_matches_causal_mask(Tq, S):
    vis = visible(Tq, S)
    owned = np.zeros((Tq, DH), int)
    lse_owned = np.zeros(Tq, int)
    for w in wide_schedule(Tq, S):
        owned[np.ix_(w["rows"], w["cols"])] += 1
        if w["writes_lse"]:
            lse_owned[w["rows"]] += 1
        assert w["kv_end"] <= S and (w["n_tiles"] - 1) * BK < w["kv_end"]
        keys = np.concatenate([np.arange(it * BK, (it + 1) * BK) for it in w["tiles"]] or [np.zeros(0, int)])
        live = keys < w["kv_end"]
        # the warp's tiles cover every key its rows see, and no tile it skips holds one
        for r in w["rows"]:
            assert set(np.flatnonzero(vis[r])) <= set(keys[live])
        for it in set(range(w["n_tiles"])) - set(w["tiles"]):
            assert not vis[np.ix_(w["rows"], np.arange(it * BK, min((it + 1) * BK, S)))].any()
    assert (owned == 1).all() and (lse_owned == 1).all()


# ---- (c) the wide forward's arithmetic ---------------------------------------

def wide_forward_emulation(q, k, v, bias, scale):
    """The wide kernel's arithmetic over the mirrored schedule: f32 sums of
    bf16 products, scale, bias and masks in f32 (−inf past the stream's end,
    −0.7·f32max past a row's causal limit), an online softmax from
    m = −0.7·f32max over the warp's tiles, P rounded to bf16 before P·V
    (row sums from P in f32), out rounded to bf16."""
    B, H, Tq, _ = q.shape
    S = k.shape[2]
    out = torch.zeros(B, H, Tq, DH, dtype=torch.bfloat16)
    lse = torch.zeros(B, H, Tq)
    b_row = bias.float() if bias is not None else torch.zeros(B, S)
    for w in wide_schedule(Tq, S):
        rows, cols = torch.from_numpy(w["rows"]), torch.from_numpy(w["cols"])
        if len(rows) == 0:
            continue
        qr = q[:, :, rows].float()
        m = torch.full((B, H, len(rows)), NEG_BIG)
        l = torch.zeros(B, H, len(rows))
        acc = torch.zeros(B, H, len(rows), len(cols))
        for it in w["tiles"]:
            keys = torch.arange(it * BK, (it + 1) * BK)
            live = keys < w["kv_end"]
            idx = keys.clamp(max=S - 1)
            kt = torch.where(live[:, None], k[:, :, idx].float(), 0.0)
            vt = torch.where(live[:, None], v[:, :, idx][..., cols].float(), 0.0)
            s = torch.einsum("bhqd,bhkd->bhqk", qr, kt) * scale + torch.where(live, b_row[:, idx], 0.0)[:, None, None]
            s = torch.where(keys[None, :] > (S - Tq) + rows[:, None], torch.tensor(NEG_BIG), s)
            s = torch.where(live, s, torch.tensor(-float("inf")))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vt)
            m = m_new
        lc = l.clamp(min=1e-30)
        out[:, :, rows[:, None], cols[None, :]] = (acc / lc[..., None]).to(torch.bfloat16)
        if w["writes_lse"]:
            lse[:, :, rows] = m + torch.log(lc)
    return out, lse


def _case(Tq, S, n_pad, seed, B=2, H=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Tq, DH), np.float32)
    k, v = (rng.standard_normal((B, H, S, DH), np.float32) for _ in range(2))
    bias = np.zeros((B, S), np.float32)
    bias[1, :n_pad] = NEG_BIG
    rows = np.ones((B, Tq), bool)
    rows[1] = (np.arange(Tq) + S - Tq) >= n_pad
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(torch.bfloat16) for a in (jq, jk, jv))
    return (jq, jk, jv, jnp.asarray(bias)), (tq, tk, tv, torch.from_numpy(bias)), torch.from_numpy(rows)


def excess(got, ref):
    return ((got.float() - ref.float()).abs() - TOL[1] * ref.float().abs()).amax(dim=(1, 3))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)


@pytest.mark.parametrize("Tq,S,n_pad,bq,bk", [(10, 128, 0, 16, 32), (8, 8, 3, 8, 8), (100, 100, 37, 32, 32),
                                              (10, 40, 40, 16, 8)])
def test_wide_arithmetic_matches_jax_forward(interpret, Tq, S, n_pad, bq, bk):
    """The Wordle append (Tq = 10 over S = 128), the header prefill with a
    padded row, a prefill with left padding, and an append whose batch-1
    row sees no key at all."""
    scale = 1.0 / DH**0.5
    jargs, targs, rows = _case(Tq, S, n_pad, seed=Tq + S)
    jout, jlse = jfa._flash_forward(*jargs, True, scale, bq, bk)
    jout = torch.from_numpy(np.array(jnp.asarray(jout, jnp.float32)))
    jlse = torch.from_numpy(np.array(jlse))
    out, lse = wide_forward_emulation(*targs, scale)
    ref, ref_lse = tfa._plain_attention(*targs, True, scale)
    live = rows[:, None, :].expand_as(lse)
    for other, other_lse in ((jout, jlse), (ref, ref_lse)):
        if rows.any():
            assert excess(out, other)[rows].max().item() <= TOL[0]
            assert (lse - other_lse).abs()[live].max().item() <= LSE_TOL
    dead = ~live
    neg_big = torch.tensor(NEG_BIG, dtype=torch.float32)
    for got in (lse, jlse, ref_lse):
        assert (got[dead] == neg_big).all()
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()


# ---- (d) K4's Dh > 128 route -----------------------------------------------------

GROUP_LANES, WARPS_K4 = 8, 8  # lanes per key row; warps per block
GROUPS = WARPS_K4 * 32 // GROUP_LANES  # key rows in flight per block and step (32)


def group_keys(n_keys):
    """Mirror of decode_attn_wide_kernel's key assignment: warp w's step
    starts at key w·4 and advances by 32; lane group i of the warp takes
    key jw + i, if below n_keys. → [group] → its keys, in order."""
    keys = [[] for _ in range(GROUPS)]
    for w in range(WARPS_K4):
        for jw in range(w * (32 // GROUP_LANES), n_keys, GROUPS):
            for i in range(32 // GROUP_LANES):
                if jw + i < n_keys:
                    keys[w * (32 // GROUP_LANES) + i].append(jw + i)
    return keys


@pytest.mark.parametrize("n_keys", [1, 9, 16, 17, 68, 128, 676])
def test_wide_decode_groups_partition_the_keys(n_keys):
    """Every key 0..index is read by exactly one group, and each lane of a
    group holds 32 dims: the 8 lanes cover Dh = 256 once."""
    seen = sorted(j for g in group_keys(n_keys) for j in g)
    assert seen == list(range(n_keys))
    dims = sorted(d for li in range(GROUP_LANES) for d in range(32 * li, 32 * li + 32))
    assert dims == list(range(DH))


def wide_decode_emulation(q, k, v, index, bias, scale):
    """The route's arithmetic in f32: each group's online softmax over its
    keys from m = −inf, then one weight per group e^(m_g − M) (M the groups'
    max), out = Σ_g acc_g·w_g / Σ_g l_g·w_g."""
    B, H = q.shape[:2]
    n_keys = index + 1
    b_row = bias.float() if bias is not None else torch.zeros(B, k.shape[2])
    ms, ls, accs = [], [], []
    for keys in group_keys(n_keys):
        m = torch.full((B, H), -float("inf"))
        l = torch.zeros(B, H)
        acc = torch.zeros(B, H, DH)
        for j in keys:
            s = (q[:, :, 0].float() * scale * k[:, :, j].float()).sum(-1) + b_row[:, j][:, None]
            m_new = torch.maximum(m, s)
            alpha, p = torch.exp(m - m_new), torch.exp(s - m_new)
            l = l * alpha + p
            acc = acc * alpha[..., None] + p[..., None] * v[:, :, j].float()
            m = m_new
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    M = torch.stack(ms).amax(0)
    w = [torch.exp(m - M) for m in ms]
    lsum = sum(l * wi for l, wi in zip(ls, w)).clamp(min=1e-30)
    return (sum(a * wi[..., None] for a, wi in zip(accs, w)) / lsum[..., None])[:, :, None]


@pytest.mark.parametrize("index,padded", [(8, False), (67, True), (127, False), (675, True)])
def test_wide_decode_arithmetic_matches_plain(index, padded):
    """Short, middle and long fills (8, 67, 127) and a served Text-Nav
    turn's last step (675, left-padded), in f32 against the plain version:
    summation order only (2e-5)."""
    B, H, T_max = 3, 2, 676
    rng = np.random.default_rng(index)
    q = torch.from_numpy(rng.standard_normal((B, H, 1, DH), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, H, T_max, DH), np.float32)) for _ in range(2))
    bias = None
    if padded:  # left padding that keeps key `index` visible; one row's pad spans most groups' keys
        n_pad = torch.tensor([0, 5, index - 3])
        bias = torch.where(torch.arange(T_max)[None, :] >= n_pad[:, None], 0.0, NEG_BIG).float()
    scale = 1.0 / DH**0.5
    got = wide_decode_emulation(q, k, v, index, bias, scale)
    ref = tda._plain_decode_attention(q, k, v, index, bias, scale)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, rtol=2e-5)
