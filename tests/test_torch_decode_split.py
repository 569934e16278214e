"""K4's split route (`csrc/decode_attn.cu`, Dh ≤ 128 at small B·H), on the CPU.

The kernel runs only on the card (tests/test_torch_kernels.py and
chip_smoke.py hold it to its plain version there). What is checked here:

(a) `_decode_splits` and the kernel's cut (`split_ranges`, a mirror of its
    index arithmetic): every key 0..index falls in
    exactly one non-empty split of at least 64 keys; the count is 1 at and
    above two blocks per SM and at Dh > 128, so the B = 512 serving rollout,
    GPT-J's paths and the B ≥ 100 dialog shapes keep the one-block route;
    below it the blocks come to about four per SM; the count is the same
    on every call.
(b) The split route's arithmetic emulated in PyTorch: in each split, the
    kernel's groups run an online softmax over keys begin + g, + NG, ... (NG
    = 32, 16, 8 groups for Dh ≤ 32, 64, 128), the block merges its groups
    into (m, l, acc), and the partials are merged in split order, with
    weight exp(m_s − M). Held against the JAX package's
    `_decode_attention_dispatch` (its Pallas kernel in interpret mode) and
    `_xla_decode_attention`, and the port's plain version, in f32 (TOL 1e-4)
    and bf16 (1e-2 + 2⁻⁶ relative), with and without bias, at indices at and
    across split boundaries, with splits wholly masked by left padding.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lmrl_gym_tpu.ops.decode_attention as jda
from lmrl_gym_torch.ops import decode_attention as tda

NEG_BIG = -0.7 * float(np.finfo(np.float32).max)
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-2, 2.0**-6)}  # (atol, rtol), as chip_smoke.py
H100_SMS = 132


# ---- (a) the split count -----------------------------------------------------

def split_ranges(n_keys: int, splits: int) -> list:
    """The keys [begin, end) of each split, as decode_attn_split_kernel cuts
    them: split s reads [s·n // splits, (s + 1)·n // splits)."""
    return [(s * n_keys // splits, (s + 1) * n_keys // splits) for s in range(splits)]


@pytest.mark.parametrize("n_sms", [H100_SMS, 114, 8])
@pytest.mark.parametrize("head_dim", [8, 32, 48, 64, 128, 136, 256])
def test_splits_cover_every_key_once(n_sms, head_dim):
    for bh in (1, 2, 3, 4, 7, 12, 48, 64, 96, 192, n_sms - 1, 2 * n_sms - 1, 2 * n_sms, 400, 512, 6144):
        for n_keys in list(range(1, 300)) + [511, 512, 513, 640, 677, 793, 1024, 4095, 4096, 4097, 20000]:
            splits = tda._decode_splits(bh, 1, head_dim, n_keys, n_sms)
            assert splits == tda._decode_splits(1, bh, head_dim, n_keys, n_sms)  # B·H decides, not B or H
            ranges = split_ranges(n_keys, splits)
            assert len(ranges) == splits and ranges[0][0] == 0 and ranges[-1][1] == n_keys
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))  # consecutive: each key once
            if head_dim > 128 or bh >= 2 * n_sms:
                assert splits == 1
            if splits > 1:
                assert min(e - b for b, e in ranges) >= 64
                assert splits <= 64
                assert (splits - 1) * bh < 4 * n_sms  # about four blocks per SM, not more
            else:
                assert head_dim > 128 or bh >= 2 * n_sms or n_keys < 128 or 4 * n_sms <= bh


@pytest.mark.parametrize("B,H,Dh,n_keys,want", [
    (512, 12, 64, 128, 1),   # the serving rollout
    (256, 16, 256, 128, 1),  # GPT-J's rollout
    (16, 16, 256, 677, 1),   # GPT-J's Text-Nav turn
    (100, 4, 32, 264, 1),    # the dialog oracle at B = 100
    (128, 4, 64, 816, 1),    # the dialog reranker at B = 128
    (16, 4, 64, 793, 9),     # the f32 dialog policy at B = 16
    (16, 12, 64, 660, 3),    # a served Text-Nav turn (GPT-2-small)
    (8, 12, 64, 135, 2),     # a text-env turn at B = 8
    (8, 12, 64, 58, 1),      # LMServer's short answers: fewer than 128 keys
    (1, 4, 48, 800, 12),     # the Car-Dealer buyer at B = 1
])
def test_split_count_on_the_paths(B, H, Dh, n_keys, want):
    assert tda._decode_splits(B, H, Dh, n_keys, H100_SMS) == want


# ---- (b) the arithmetic -----------------------------------------------------

def n_groups(head_dim: int) -> int:
    """Groups per block: 4 warps of 32 / G groups, G = 4, 8, 16 lanes per key row."""
    lanes = 4 if head_dim <= 32 else 8 if head_dim <= 64 else 16
    return 4 * (32 // lanes)


def split_emulation(q, k, v, index, bias, scale, n_sms=H100_SMS):
    """The split route's arithmetic in f32 (bf16 inputs widened, the output
    rounded to v's dtype): per split, per group an online softmax from
    m = −inf over its keys in order; the block's merge of its groups; the
    ordered merge of the splits' partials."""
    B, H, _, Dh = q.shape
    n_keys = index + 1
    splits = tda._decode_splits(B, H, Dh, n_keys, n_sms)
    ng = n_groups(Dh)
    qs = q[:, :, 0].float() * scale
    parts = []
    for begin, end in split_ranges(n_keys, splits):
        m = torch.full((B, H, ng), -float("inf"))
        l = torch.zeros(B, H, ng)
        acc = torch.zeros(B, H, ng, Dh)
        for j0 in range(begin, end, ng):
            j = torch.arange(j0, j0 + ng)
            live = (j < end)[None, None]
            jj = j.clamp(max=end - 1)
            s = (qs[:, :, None] * k[:, :, jj].float()).sum(-1)
            if bias is not None:
                s = s + bias[:, jj].float()[:, None]
            m_new = torch.where(live, torch.maximum(m, s), m)
            alpha = torch.where(live, torch.exp(m - m_new), torch.ones(()))
            p = torch.where(live, torch.exp(s - m_new), torch.zeros(()))
            l = l * alpha + p
            acc = acc * alpha[..., None] + p[..., None] * v[:, :, jj].float()
            m = m_new
        M = m.amax(-1)
        w = torch.exp(m - M[..., None])  # 0 for a group that got no key
        parts.append((M, (l * w).sum(-1), (acc * w[..., None]).sum(-2)))
    M = torch.stack([p[0] for p in parts]).amax(0)
    lsum = torch.zeros(B, H)
    o = torch.zeros(B, H, Dh)
    for m_s, l_s, a_s in parts:  # in split order
        w = torch.exp(m_s - M)
        lsum = lsum + l_s * w
        o = o + a_s * w[..., None]
    return (o / lsum.clamp(min=1e-30)[..., None]).to(v.dtype)[:, :, None], splits


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jda, "_FORCE_INTERPRET", True)


def _excess(got, ref, dtype, rows=slice(None)):
    return ((got.float() - ref.float()).abs() - TOL[dtype][1] * ref.float().abs())[rows].max().item()


# indices at and across split boundaries (B·H = 4: splits = (index + 1) // 64
# up to 64): 1 split below 128 keys; 2 splits of 64; 2 of 64 and 65; 3 of 64;
# 4 of 64; 4 of 75-76; 5 of 64
INDICES = (63, 127, 128, 191, 255, 300, 319)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", [32, 48, 64, 128])
@pytest.mark.parametrize("with_bias", [False, True])
def test_split_arithmetic_matches_jax_decode(interpret, dtype, Dh, with_bias):
    """Batch row 1's first 150 keys are masked: at index 255 the first two
    of four splits are wholly masked, at 300 the first one of four. Below
    index 150 that row sees no key, and its output is garbage in every
    version (as on the card: a decode step always sees its own slot), so
    only rows that see a key are compared."""
    B, H, S = 2, 2, 320
    rng = np.random.default_rng(Dh + 7 * with_bias)
    arrays = [rng.standard_normal(shape, np.float32) for shape in ((B, H, 1, Dh), (B, H, S, Dh), (B, H, S, Dh))]
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(a, jdtype) for a in arrays)
    tq, tk, tv = (torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(dtype) for a in (jq, jk, jv))
    bias = None
    if with_bias:
        bias = np.zeros((B, S), np.float32)
        bias[1, :150] = NEG_BIG
    jbias = None if bias is None else jnp.asarray(bias)
    tbias = None if bias is None else torch.from_numpy(bias)
    scale = Dh**-0.5
    n_split = 0
    for index in INDICES:
        out, splits = split_emulation(tq, tk, tv, index, tbias, scale)
        n_split += splits > 1
        jout = jda._decode_attention_dispatch(jq, jk, jv, jnp.int32(index), jbias, scale, 64, True)
        jref = jda._xla_decode_attention(jq, jk, jv, jnp.int32(index), jbias, scale)
        ref = tda._plain_decode_attention(tq, tk, tv, index, tbias, scale)
        assert out.shape == ref.shape == (B, H, 1, Dh) and out.dtype == ref.dtype == dtype
        assert torch.isfinite(out.float()).all()
        rows = slice(None) if bias is None or index >= 150 else slice(0, 1)
        for other in (jout, jref):
            other = torch.from_numpy(np.array(jnp.asarray(other, jnp.float32)))
            assert _excess(out, other, dtype, rows) <= TOL[dtype][0], index
        assert _excess(out, ref, dtype, rows) <= TOL[dtype][0], index
    assert n_split == len(INDICES) - 1  # every index but 63 takes the split route


def test_wholly_masked_split_takes_no_weight():
    """Four splits of 64 keys; batch row 1 masks keys 0..149, so its splits 0
    and 1 hold masked keys only: their m is ≈ −0.7·f32max, their weight in
    the merge exp(m − M) is 0, and no NaN appears."""
    B, H, Dh, S, index = 2, 2, 64, 256, 255
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(B, H, T, Dh, generator=g) for T in (1, S, S))
    bias = torch.zeros(B, S)
    bias[1, :150] = NEG_BIG
    out, splits = split_emulation(q, k, v, index, bias, 0.125)
    assert splits == 4
    unmasked, _ = split_emulation(q[1:, :, :, :], k[1:, :, 150:], v[1:, :, 150:], index - 150, None, 0.125)
    assert torch.isfinite(out).all()
    assert (out[1:] - unmasked).abs().max().item() <= TOL[torch.float32][0]
