"""The tensor-core backward kernels (`csrc/flash_bwd_tc.cu`), on the CPU.

The kernels run only on the card (tests/test_torch_kernels.py holds them to
their plain versions there). What is checked here:

(a) `_variant`: which kernels take each (dtype, head dim) the port's
    configs use.
(b) The tile schedule (blocks own 64 rows and stream the other side in
    32-row tiles): a mirror of the kernels' index arithmetic (the last key
    tile a K2 block streams, the first query tile a K3 block streams)
    against a brute-force causal mask, over a grid of (Tq, S).
(c) The kernels' arithmetic, emulated in PyTorch — bf16 operands, f32
    products and sums, P and dS rounded to bf16 before the second
    products — against the JAX package's `_flash_backward` on bf16 inputs,
    its Pallas kernels in interpret mode, and against the port's plain
    versions (which keep P and dS in f32), within chip_smoke.py's bf16
    GRAD_TOL. One bf16 rounding of P and dS is a relative error ≤ 2⁻⁹ per
    term, summed over up to S keys (or Tq queries) of mixed sign: it stays
    well inside the tolerance's 2⁻⁶ relative, so the tolerance needs no
    widening.
(d) The alignment rule the tensor-core wrappers enforce.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lmrl_gym_tpu.ops.flash_attention as jfa
from lmrl_gym_torch.ops import flash_attention as tfa

NEG_BIG = -0.7 * float(np.finfo(np.float32).max)
GRAD_TOL = (1e-2, 2.0**-6)  # bf16 (atol, rtol), as chip_smoke.py and tests/test_torch_kernels.py
TILE = 64  # rows a block owns: queries (K2) or keys (K3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128, 256])
def test_variant_choice(dtype, head_dim):
    """bf16 with Dh a multiple of 16 up to 128 takes the tensor cores; f32
    (TF32 is off) and Dh = 256 keep the fp32 CUDA-core kernels (the
    forward's tensor cores go to 256: tests/test_torch_flash_fwd_tc.py)."""
    want = "tc" if dtype == torch.bfloat16 and head_dim <= 128 else "simt"
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert tfa._variant(dtype, head_dim, name) == want


def test_variant_choice_needs_whole_k16_steps():
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert tfa._variant(torch.bfloat16, 24, name) == "simt"
        assert tfa._variant(torch.bfloat16, 48, name) == "tc"


# ---- (b) the tile schedule -------------------------------------------------

BK = BQ = 32  # rows of the streamed tiles: keys (K2, launch_dq) and queries (K3, launch_dkv)


def k2_key_tiles(q_tile, Tq, S):
    """Mirror of flash_bwd_dq_tc_kernel: the block of query tile `q_tile`
    streams key tiles 0 .. ceil(kv_end / BK) − 1 and masks keys at or past
    kv_end = min(S, offset + q_last + 1)."""
    q_last = min((q_tile + 1) * TILE, Tq) - 1
    kv_end = min(S, S - Tq + q_last + 1)
    return range((kv_end + BK - 1) // BK), kv_end


def k3_query_tiles(k_tile, Tq, S):
    """Mirror of flash_bwd_dkv_tc_kernel: the block of key tile `k_tile`
    streams query tiles from max(0, k0 − offset) // BQ to the end."""
    it0 = max(0, k_tile * TILE - (S - Tq)) // BQ
    return range(it0, (Tq + BQ - 1) // BQ)


def visible(Tq, S):
    """[Tq, S] causal mask, queries right-aligned at offset S − Tq."""
    return (np.arange(Tq)[:, None] + (S - Tq)) >= np.arange(S)[None, :]


def live_tiles(sub, reduce_axis, tile):
    """The `tile`-sized tiles along the kept axis of the mask `sub` that
    hold a visible pair."""
    return sorted({i // tile for i in np.nonzero(sub.any(axis=reduce_axis))[0]})


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("pad", [0, 1, 31, 63, 64, 100])
def test_tile_schedule_matches_causal_mask(kernel, pad):
    for Tq in (1, 16, 31, 37, 63, 64, 65, 100, 127, 128, 129, 160, 200):
        S = Tq + pad
        mask = visible(Tq, S)
        if kernel == "dq":
            for q_tile in range((Tq + TILE - 1) // TILE):
                rows = slice(q_tile * TILE, (q_tile + 1) * TILE)
                tiles, kv_end = k2_key_tiles(q_tile, Tq, S)
                live = live_tiles(mask[rows], 0, BK)
                assert tiles[-1] == live[-1], (Tq, S, q_tile)  # stops at the last live key tile
                assert not mask[rows, kv_end:].any(), (Tq, S, q_tile)  # nothing visible is masked off
        else:
            for k_tile in range((S + TILE - 1) // TILE):
                cols = slice(k_tile * TILE, (k_tile + 1) * TILE)
                tiles = k3_query_tiles(k_tile, Tq, S)
                live = live_tiles(mask[:, cols], 1, BQ)
                assert tiles[0] == live[0], (Tq, S, k_tile)  # starts at the first live query tile
                assert set(live) <= set(tiles), (Tq, S, k_tile)


# ---- (c) the arithmetic -----------------------------------------------------

def tc_emulation(q, k, v, bias, lse, delta, dout, scale):
    """The tensor-core kernels' arithmetic: S and dP from bf16 operands in
    f32, P and dS rounded to bf16 as the A operand of the second products,
    f32 sums, outputs rounded to bf16."""
    p, ds = tfa._plain_dscores(q, k, v, bias, lse, delta, dout, True, scale)
    p, ds = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dout.float())
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def excess(got, ref):
    return ((got.float() - ref.float()).abs() - GRAD_TOL[1] * ref.float().abs()).max().item()


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)


@pytest.mark.parametrize("Tq,S", [(160, 160), (96, 160)])
def test_tc_arithmetic_matches_jax_backward(interpret, Tq, S):
    B, H, Dh = 2, 2, 64
    scale = 1.0 / Dh**0.5
    rng = np.random.default_rng(Tq + S)
    q, g = (rng.standard_normal((B, H, Tq, Dh), np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, H, S, Dh), np.float32) for _ in range(2))
    bias = np.zeros((B, S), np.float32)
    bias[1, :37] = NEG_BIG  # left padding: batch 1's first 37 keys
    rows = (np.arange(Tq) + S - Tq) >= 37
    g[1, :, ~rows] = 0.0  # fully masked query rows get a zero cotangent, as every loss gives them
    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g))
    jout, jlse = jfa._flash_forward(jq, jk, jv, jnp.asarray(bias), True, scale, 128, 128)
    jgrads = jfa._flash_backward(jq, jk, jv, jnp.asarray(bias), jout, jlse, jg, True, scale, 128, 128)[:3]

    def to_torch(a):
        return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))

    tq, tk, tv, tg, out = (to_torch(a).to(torch.bfloat16) for a in (jq, jk, jv, jg, jout))
    lse, tbias = to_torch(jlse), torch.from_numpy(bias)
    delta = tfa._delta(out, tg)
    emulated = tc_emulation(tq, tk, tv, tbias, lse, delta, tg, scale)
    plain = (tfa._plain_bwd_dq(tq, tk, tv, tbias, lse, delta, tg, True, scale),
             *tfa._plain_bwd_dkv(tq, tk, tv, tbias, lse, delta, tg, True, scale))
    for name, e, p, j in zip(("dq", "dk", "dv"), emulated, plain, jgrads):
        j = to_torch(j)
        assert e.shape == j.shape, name
        assert torch.isfinite(e.float()).all(), name
        assert excess(e, j) <= GRAD_TOL[0], name  # against the JAX package's Pallas backward
        assert excess(e, p) <= GRAD_TOL[0], name  # against the plain version chip_smoke.py holds the kernel to
        assert excess(p, j) <= GRAD_TOL[0], name


# ---- (d) alignment ------------------------------------------------------------

def test_alignment_rule_takes_fused_qkv_views():
    """q/k/v as the trunk passes them: views into a fused [B, T, 3, H, Dh]
    projection, also with right-aligned queries (an offset of whole rows)."""
    B, T, H, Dh, Tq = 2, 40, 3, 16, 17
    qkv = torch.zeros(B, T, 3, H, Dh, dtype=torch.bfloat16)
    q = qkv[:, T - Tq:, 0].transpose(1, 2)
    k, v = qkv[:, :, 1].transpose(1, 2), qkv[:, :, 2].transpose(1, 2)
    dout = torch.zeros(B, Tq, H, Dh, dtype=torch.bfloat16).transpose(1, 2)
    tfa._check_tc_alignment(q=q, k=k, v=v, dout=dout)


@pytest.mark.parametrize("case", ["shifted start", "row stride 68", "head stride 4"])
def test_alignment_rule_refuses(case):
    B, H, T, Dh = 1, 2, 8, 64
    if case == "shifted start":
        t = torch.zeros(B * H * T * Dh + 1, dtype=torch.bfloat16)[1:].view(B, H, T, Dh)
    elif case == "row stride 68":
        t = torch.zeros(B, H, T, Dh + 4, dtype=torch.bfloat16)[..., :Dh]
    else:
        t = torch.zeros(2 * B * H * T * Dh, dtype=torch.bfloat16).as_strided((B, H, T, Dh), (T * Dh, 4, Dh, 1))
    with pytest.raises(ValueError):
        tfa._check_tc_alignment(q=t)


def test_cpu_bf16_backward_takes_plain_path_and_counts_nothing():
    rng = np.random.default_rng(3)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((1, 2, 9, 64), np.float32)).to(torch.bfloat16) for _ in range(4))
    lse, delta = torch.zeros(1, 2, 9), torch.zeros(1, 2, 9)
    wrappers = (tfa.flash_bwd_dq, tfa.flash_bwd_dkv)
    before = [(w.launches, w.tc_launches) for w in wrappers]
    dq = tfa.flash_bwd_dq(q, k, v, None, lse, delta, g)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, None, lse, delta, g)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert [(w.launches, w.tc_launches) for w in wrappers] == before
