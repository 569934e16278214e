"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests import neither JAX nor the JAX package, so they also run where
only PyTorch is installed:

    python -m pytest tests/test_torch_kernels.py --noconftest -o addopts="" -q

Without a CUDA device every test here skips (the kernels have no CPU mode).
Tolerances, |kernel − plain| ≤ atol + rtol·|plain|: f32 atol 1e-4
(summation order only); bf16 atol 1e-2, rtol 2⁻⁶ — two bf16 ulps, since
both sides round the output (and the plain version its probabilities) to
bf16. The tensor-core kernels also round P (and the backward dS) to bf16
before their second products; tests/test_torch_flash_fwd_tc.py and
tests/test_torch_flash_bwd_tc.py show on the CPU that this stays inside the
same tolerance.
"""
import numpy as np
import pytest
import torch

from lmrl_gym_torch.models.config import tiny_test_config
from lmrl_gym_torch.models.transformer import KVCache, Transformer
from lmrl_gym_torch.ops import decode_attention as tda
from lmrl_gym_torch.ops import flash_attention as tfa

NEG_BIG = -0.7 * float(np.finfo(np.float32).max)
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-2, 2.0**-6)}  # (atol, rtol)

pytestmark = pytest.mark.cuda


def excess(out, ref, dtype):
    """Elementwise |out − ref| − rtol·|ref|, to hold against atol."""
    rtol = TOL[dtype][1]
    return (out.float() - ref.float()).abs() - rtol * ref.float().abs()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _randn(*shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to("cuda", dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "Tq,S,Dh,padded",
    [(8, 8, 64, False), (10, 128, 64, False), (64, 64, 64, True), (200, 200, 32, True), (3, 40, 128, False), (17, 33, 256, True)],
)
def test_flash_kernel_matches_plain(cuda, dtype, Tq, S, Dh, padded):
    B, H = 4, 3
    q, k, v = (_randn(B, H, T, Dh, dtype=dtype, seed=i) for i, T in enumerate((Tq, S, S)))
    bias = None
    if padded:
        n_pad = torch.tensor([0, 3, S // 2, S - 1])
        bias = torch.where(torch.arange(S)[None, :] >= n_pad[:, None], 0.0, NEG_BIG).float().cuda()
    before = tfa.flash_fwd.launches
    out, lse = tfa.flash_fwd(q, k, v, bias)
    assert tfa.flash_fwd.launches == before + 1
    ref, ref_lse = tfa._plain_attention(q, k, v, bias, True, 1.0 / Dh**0.5)
    torch.cuda.synchronize()
    # fully padded query rows hold garbage in both: compare rows that see a key
    rows = torch.ones(B, Tq, dtype=torch.bool, device="cuda") if bias is None else bias[:, S - Tq:] == 0
    err = excess(out, ref, dtype).amax(dim=(1, 3))
    assert err[rows].max().item() <= TOL[dtype][0]
    assert (lse - ref_lse).abs().amax(dim=1)[rows].max().item() <= 1e-3


def test_flash_kernel_takes_strided_cache_prefix(cuda):
    """A cached append passes cache[:, :, :index+T] (a strided view)."""
    B, H, T_max, Dh, T, index = 2, 4, 64, 64, 10, 30
    cache_k = _randn(B, H, T_max, Dh, dtype=torch.bfloat16, seed=1)
    cache_v = _randn(B, H, T_max, Dh, dtype=torch.bfloat16, seed=2)
    qkv = _randn(B, T, 3, H, Dh, dtype=torch.bfloat16, seed=3)
    q = qkv[:, :, 0].transpose(1, 2)  # [B,H,T,Dh] view with row stride 3*H*Dh
    S = index + T
    out = tfa.flash_attention(q, cache_k[:, :, :S], cache_v[:, :, :S])
    ref = tfa.flash_attention(q.cpu().float(), cache_k[:, :, :S].cpu().float(), cache_v[:, :, :S].cpu().float())
    assert excess(out.cpu(), ref, torch.bfloat16).max().item() <= TOL[torch.bfloat16][0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("index", [0, 8, 67, 127])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("Dh", [32, 64, 128, 256])
def test_decode_kernel_matches_plain(cuda, dtype, index, with_bias, Dh):
    B, H, S = 4, 3, 128
    q = _randn(B, H, 1, Dh, dtype=dtype, seed=0)
    k = _randn(B, H, S, Dh, dtype=dtype, seed=1)
    v = _randn(B, H, S, Dh, dtype=dtype, seed=2)
    bias = None
    if with_bias:
        # every row keeps key `index` visible (a fully masked row is garbage in both)
        n_pad = torch.tensor([0, min(1, index), index // 2, index])
        bias = torch.where(torch.arange(S)[None, :] >= n_pad[:, None], 0.0, NEG_BIG).float().cuda()
    before = tda.decode_attention.launches
    out = tda.decode_attention(q, k, v, index, bias, 0.125)
    assert tda.decode_attention.launches == before + 1
    ref = tda._plain_decode_attention(q, k, v, index, bias, 0.125)
    torch.cuda.synchronize()
    assert excess(out, ref, dtype).max().item() <= TOL[dtype][0]


# (Tq, S) of the forward's variant tests: one query, serving's header
# prefill (8, 8) and appends (10 over 28..128), the next window (16, 16),
# queries right-aligned over a ragged S, the train step's T = 160, and a
# ragged T past two 64-row blocks
FWD_SHAPES = [(1, 40), (8, 8), (10, 28), (10, 88), (10, 128), (16, 16), (37, 100), (160, 160), (129, 130)]


def _left_pad_bias(B, S, n_pad):
    """[B, S] f32 bias masking each row's first n_pad[b] keys."""
    return torch.where(torch.arange(S)[None, :] >= torch.tensor(n_pad)[:, None], 0.0, NEG_BIG).float().cuda()


def _check_fwd_against_plain(q, k, v, bias, variant: str):
    """One forward launch of `variant` against the plain version: out
    within TOL and lse within 1e-3 on the query rows that see a key; on
    fully masked (left-pad) rows lse finite and equal to the plain
    version's (−0.7·f32max in both), which the backward reads as P = 1."""
    B, H, Tq, Dh = q.shape
    S = k.shape[2]
    before = (tfa.flash_fwd.launches, tfa.flash_fwd.tc_launches)
    out, lse = tfa.flash_fwd(q, k, v, bias)
    assert (tfa.flash_fwd.launches - before[0], tfa.flash_fwd.tc_launches - before[1]) == (1, int(variant == "tc"))
    ref, ref_lse = tfa._plain_attention(q, k, v, bias, True, 1.0 / Dh**0.5)
    torch.cuda.synchronize()
    rows = torch.ones(B, Tq, dtype=torch.bool, device="cuda") if bias is None else bias[:, S - Tq:] == 0
    assert excess(out, ref, torch.bfloat16).amax(dim=(1, 3))[rows].max().item() <= TOL[torch.bfloat16][0]
    assert (lse - ref_lse).abs().amax(dim=1)[rows].max().item() <= 1e-3
    dead = (~rows)[:, None, :].expand_as(lse)
    assert torch.isfinite(lse).all()
    assert torch.equal(lse[dead], ref_lse[dead])
    assert (lse[dead] == NEG_BIG).all()


@pytest.mark.parametrize("variant", ["tc", "simt"])
@pytest.mark.parametrize("Tq,S", FWD_SHAPES)
@pytest.mark.parametrize("Dh", [16, 48, 64, 128])
@pytest.mark.parametrize("padded", [False, True])
def test_flash_fwd_variants_match_plain(cuda, monkeypatch, variant, Tq, S, Dh, padded):
    """Each forward variant, forced, in bf16: both block shapes of the
    tensor-core kernel (Tq ≤ 16: one (b, h) per warp; else 64 rows per
    block), ragged S past the key tiles, Dh from 16 to 128, and left padding
    that masks whole query rows."""
    monkeypatch.setattr(tfa, "_variant", lambda dtype, head_dim: variant)
    B, H = 3, 2
    q, k, v = (_randn(B, H, T, Dh, dtype=torch.bfloat16, seed=i + Tq + S) for i, T in enumerate((Tq, S, S)))
    bias = _left_pad_bias(B, S, [0, min(3, S - 1), S - 1]) if padded else None
    _check_fwd_against_plain(q, k, v, bias, variant)


@pytest.mark.parametrize("variant", ["tc", "simt"])
@pytest.mark.parametrize("T,index", [(8, 0), (10, 30), (10, 118), (16, 0), (37, 63)])
def test_flash_fwd_variants_take_strided_views(cuda, monkeypatch, variant, T, index):
    """As the trunk calls K1 on a cached append: q a view into the fused
    [B, T, 3, H, Dh] projection (row stride 3·H·Dh), k/v the filled prefix
    cache[:, :, :index + T] of a [B, H, T_max, Dh] cache, and the bias row a
    [:, :S] slice of a [B, T_max] mask with left padding."""
    monkeypatch.setattr(tfa, "_variant", lambda dtype, head_dim: variant)
    B, H, T_max, Dh = 3, 4, 128, 64
    S = index + T
    qkv = _randn(B, T, 3, H, Dh, dtype=torch.bfloat16, seed=3)
    cache_k = _randn(B, H, T_max, Dh, dtype=torch.bfloat16, seed=1)
    cache_v = _randn(B, H, T_max, Dh, dtype=torch.bfloat16, seed=2)
    cache_k[:, :, index:S] = qkv[:, :, 1].transpose(1, 2)
    cache_v[:, :, index:S] = qkv[:, :, 2].transpose(1, 2)
    q = qkv[:, :, 0].transpose(1, 2)
    bias = _left_pad_bias(B, T_max, [0, 2, S // 2])[:, :S]
    _check_fwd_against_plain(q, cache_k[:, :, :S], cache_v[:, :, :S], bias, variant)


@pytest.mark.parametrize("variant", ["tc", "simt"])
@pytest.mark.parametrize("T", [16, 100, 160])
def test_flash_fwd_variants_take_fused_qkv_views(cuda, monkeypatch, variant, T):
    """As the trunk calls K1 in training: q, k and v views into one fused
    [B, T, 3, H, Dh] projection, left-padded."""
    monkeypatch.setattr(tfa, "_variant", lambda dtype, head_dim: variant)
    B, H, Dh = 3, 4, 64
    qkv = _randn(B, T, 3, H, Dh, dtype=torch.bfloat16, seed=T)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    _check_fwd_against_plain(q, k, v, _left_pad_bias(B, T, [0, 5, T // 2]), variant)


@pytest.mark.parametrize("T", [16, 100, 160])
def test_tc_forward_left_pad_rows_give_finite_gradients(cuda, T):
    """K1 (tensor cores) → K2/K3 on left-padded bf16 inputs: the forward's
    lse on fully masked rows is −0.7·f32max, so the backward rebuilds
    P = 1 there, and with the zero cotangent those rows get, every gradient
    is finite and within GRAD_TOL of the plain backward."""
    before = tfa.flash_fwd.tc_launches
    q, k, v, bias, out, lse, dout = _bwd_case(4, 3, T, T, 64, torch.bfloat16, True, seed=T)
    assert tfa.flash_fwd.tc_launches == before + 1
    dead = (bias == NEG_BIG)[:, None, :].expand_as(lse)  # Tq = S: a row is masked with its own key
    assert dead.any() and (lse[dead] == NEG_BIG).all()
    delta = tfa._delta(out, dout)
    grads = (tfa.flash_bwd_dq(q, k, v, bias, lse, delta, dout), *tfa.flash_bwd_dkv(q, k, v, bias, lse, delta, dout))
    scale = 1.0 / 64**0.5
    refs = (tfa._plain_bwd_dq(q, k, v, bias, lse, delta, dout, True, scale),
            *tfa._plain_bwd_dkv(q, k, v, bias, lse, delta, dout, True, scale))
    torch.cuda.synchronize()
    for got, ref in zip(grads, refs):
        assert torch.isfinite(got.float()).all()
        assert _grad_excess(got, ref, torch.bfloat16).max().item() <= GRAD_TOL[torch.bfloat16][0]


def test_flash_fwd_tc_refuses_misaligned_inputs(cuda):
    """The tensor-core forward copies 16-byte rows: a bf16 q that starts 2
    bytes into its buffer, or whose rows are 68 elements apart, is refused
    before any launch."""
    B, H, T, Dh = 1, 2, 16, 64
    k, v = (_randn(B, H, T, Dh, dtype=torch.bfloat16, seed=s) for s in (1, 2))
    shifted = _randn(B * H * T * Dh + 1, dtype=torch.bfloat16, seed=4)[1:].view(B, H, T, Dh)
    wide_rows = _randn(B, H, T, Dh + 4, dtype=torch.bfloat16, seed=5)[..., :Dh]
    assert tfa._variant(torch.bfloat16, Dh) == "tc"
    before = tfa.flash_fwd.launches
    for q in (shifted, wide_rows):
        with pytest.raises(ValueError):
            tfa.flash_fwd(q, k, v)
    assert tfa.flash_fwd.launches == before


def _bwd_case(B, H, Tq, S, Dh, dtype, padded, seed):
    """Inputs of one backward: q/k/v as views into a fused [B, T, 3, H, Dh]
    projection (as the trunk passes them), the forward's out and lse, and a
    cotangent that is zero on fully masked (left-pad) query rows, as every
    loss of the port gives them."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(B, S, 3, H, Dh, generator=g).to("cuda", dtype)
    q = qkv[:, S - Tq:, 0].transpose(1, 2)
    k, v = qkv[:, :, 1].transpose(1, 2), qkv[:, :, 2].transpose(1, 2)
    bias = None
    rows = torch.ones(B, Tq, dtype=torch.bool, device="cuda")
    if padded:
        n_pad = torch.tensor([0, 1, S // 2, S - 1][:B])
        bias = torch.where(torch.arange(S)[None, :] >= n_pad[:, None], 0.0, NEG_BIG).float().cuda()
        rows = bias[:, S - Tq:] == 0
    out, lse = tfa.flash_fwd(q, k, v, bias)
    dout = torch.randn(B, Tq, H, Dh, generator=g).to("cuda", dtype).transpose(1, 2)
    dout = dout * rows[:, None, :, None].to(dtype)
    return q, k, v, bias, out, lse, dout


GRAD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 2.0**-6)}  # (atol, rtol)


def _grad_excess(out, ref, dtype):
    return (out.float() - ref.float()).abs() - GRAD_TOL[dtype][1] * ref.float().abs()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("T", [1, 17, 160, 200])
@pytest.mark.parametrize("Dh", [32, 64, 128])
def test_flash_bwd_kernels_match_plain(cuda, dtype, padded, T, Dh):
    """K2 and K3, of the variant the dispatch picks (bf16: tensor cores;
    f32: CUDA cores), against their plain versions on the same inputs."""
    _check_bwd_against_plain(4, 3, T, T, Dh, dtype, padded, seed=T + Dh, tc=dtype == torch.bfloat16)


def _check_bwd_against_plain(B, H, Tq, S, Dh, dtype, padded, seed, tc: bool):
    q, k, v, bias, out, lse, dout = _bwd_case(B, H, Tq, S, Dh, dtype, padded, seed=seed)
    delta = tfa._delta(out, dout)
    wrappers = (tfa.flash_bwd_dq, tfa.flash_bwd_dkv)
    before = [(w.launches, w.tc_launches) for w in wrappers]
    dq = tfa.flash_bwd_dq(q, k, v, bias, lse, delta, dout)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, bias, lse, delta, dout)
    assert [(w.launches - n, w.tc_launches - n_tc) for w, (n, n_tc) in zip(wrappers, before)] == [(1, int(tc))] * 2
    scale = 1.0 / Dh**0.5
    ref_dq = tfa._plain_bwd_dq(q, k, v, bias, lse, delta, dout, True, scale)
    ref_dk, ref_dv = tfa._plain_bwd_dkv(q, k, v, bias, lse, delta, dout, True, scale)
    torch.cuda.synchronize()
    for got, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert _grad_excess(got, ref, dtype).max().item() <= GRAD_TOL[dtype][0]


@pytest.mark.parametrize("variant", ["tc", "simt"])
@pytest.mark.parametrize(
    "B,H,Tq,S,Dh,padded",
    [(4, 3, 100, 100, 64, True), (4, 3, 37, 100, 64, False), (2, 4, 160, 160, 128, True), (3, 2, 65, 65, 16, False),
     (2, 2, 64, 64, 32, True), (2, 2, 129, 130, 48, True)],
)
def test_flash_bwd_variants_match_plain(cuda, monkeypatch, variant, B, H, Tq, S, Dh, padded):
    """Each backward variant, forced, in bf16: ragged T (not a multiple of
    the 64-row tile), right-aligned queries, Dh from 16 to 128."""
    monkeypatch.setattr(tfa, "_variant", lambda dtype, head_dim: variant)
    _check_bwd_against_plain(B, H, Tq, S, Dh, torch.bfloat16, padded, seed=Tq + Dh, tc=variant == "tc")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tq,S,padded", [(10, 128, False), (128, 256, True), (1, 40, True), (33, 34, False)])
def test_flash_bwd_kernels_right_aligned_queries(cuda, dtype, Tq, S, padded):
    """Tq < S: queries right-aligned at offset S − Tq, as the forward."""
    q, k, v, bias, out, lse, dout = _bwd_case(4, 2, Tq, S, 64, dtype, padded, seed=Tq)
    got = tfa._FlashAttnFunction.backward(_Ctx(q, k, v, bias, out, lse), dout)[:3]
    ref = tfa._plain_flash_backward(q, k, v, bias, out, lse, dout, True, 0.125)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert _grad_excess(a, b, dtype).max().item() <= GRAD_TOL[dtype][0]


class _Ctx:
    """Stands in for autograd's ctx to call the backward directly."""

    def __init__(self, q, k, v, bias, out, lse):
        self.saved_tensors = (q, k, v, bias, out, lse)
        self.causal, self.sm_scale = True, 1.0 / q.shape[-1] ** 0.5


@pytest.mark.parametrize("padded", [False, True])
def test_flash_attention_gradients_on_card(cuda, padded):
    """The autograd function (K1 + K2 + K3) against autograd through the
    plain attention, f32, with the trunk's fused-qkv layout."""
    B, H, T, Dh = 3, 4, 150, 64
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn(B, T, 3 * H * Dh, generator=g).cuda().requires_grad_()
    bias = None
    if padded:
        n_pad = torch.tensor([0, 5, 70])
        bias = torch.where(torch.arange(T)[None, :] >= n_pad[:, None], 0.0, NEG_BIG).float().cuda()
    cot = torch.randn(B, H, T, Dh, generator=g).cuda()
    if padded:
        cot = cot * (bias == 0)[:, None, :, None]
    grads = []
    for fn in (lambda q, k, v: tfa.flash_attention(q, k, v, bias),
               lambda q, k, v: tfa._plain_attention(q, k, v, bias, True, 1.0 / Dh**0.5)[0]):
        q, k, v = (t.view(B, T, H, Dh).transpose(1, 2) for t in qkv.split(H * Dh, dim=-1))
        grads.append(torch.autograd.grad((fn(q, k, v) * cot).sum(), qkv)[0])
    assert (grads[0] - grads[1]).abs().max().item() <= 1e-4


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = _randn(1, 2, 1, 24 + 4, dtype=torch.float32, seed=0)  # Dh = 28: not a multiple of 8
    with pytest.raises(ValueError):
        tfa.flash_fwd(q, q, q)
    q, k = _randn(1, 2, 2, 64, dtype=torch.float32, seed=0), _randn(1, 2, 8, 64, dtype=torch.float32, seed=1)
    with pytest.raises(ValueError):
        tda.decode_attention(q, k, k, 3)  # two queries
    with pytest.raises(TypeError):
        tfa.flash_fwd(q.half(), k.half(), k.half())
    # the tensor-core backward copies 16-byte rows: a q that starts 2 bytes
    # into its buffer, or whose rows are 68 elements apart, is refused
    B, H, T, Dh = 1, 2, 16, 64
    k, v, dout = (_randn(B, H, T, Dh, dtype=torch.bfloat16, seed=s) for s in (1, 2, 3))
    lse, delta = torch.zeros(B, H, T, device="cuda"), torch.zeros(B, H, T, device="cuda")
    shifted = _randn(B * H * T * Dh + 1, dtype=torch.bfloat16, seed=4)[1:].view(B, H, T, Dh)
    wide_rows = _randn(B, H, T, Dh + 4, dtype=torch.bfloat16, seed=5)[..., :Dh]
    assert tfa._variant(torch.bfloat16, Dh) == "tc"
    for q in (shifted, wide_rows):
        with pytest.raises(ValueError):
            tfa.flash_bwd_dq(q, k, v, None, lse, delta, dout)
        with pytest.raises(ValueError):
            tfa.flash_bwd_dkv(q, k, v, None, lse, delta, dout)


@pytest.mark.parametrize("variant", [{}, dict(position_embedding="rotary", rotary_interleaved=True, parallel_ffn=True)])
def test_model_on_card_matches_cpu(cuda, variant):
    """Left-padded prefill + 1-token steps: the card (kernels) against the
    CPU (plain versions), f32 at tiny width."""
    cfg = tiny_test_config(**variant)
    gpu = Transformer(cfg, device="cuda")
    cpu = Transformer(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    B, T_max = 3, 24
    ids = torch.randint(0, 256, (B, 12), generator=torch.Generator().manual_seed(0))
    mask = torch.zeros(B, T_max, dtype=torch.int32)
    mask[:, :12] = (torch.arange(12)[None, :] >= torch.tensor([0, 2, 5])[:, None]).int()
    mask[:, 12:15] = 1
    pos = (mask.cumsum(1) - 1).clamp(min=0)
    caches = [KVCache.init(cfg, B, T_max, device=d) for d in ("cuda", "cpu")]
    flash0, decode0 = tfa.flash_fwd.launches, tda.decode_attention.launches
    with torch.no_grad():
        for start, T in ((0, 12), (12, 1), (13, 1), (14, 1)):
            step_ids = ids[:, start:start + T] if start < 12 else torch.full((B, 1), 97)
            outs = []
            for i, (model, d) in enumerate(((gpu, "cuda"), (cpu, "cpu"))):
                logits, _, caches[i] = model(
                    step_ids.to(d), attention_mask=mask.to(d), position_ids=pos[:, start:start + T].to(d), cache=caches[i]
                )
                outs.append(logits.float().cpu())
            real = mask[:, start:start + T].bool()
            assert (outs[0] - outs[1]).abs()[real].max().item() <= 1e-4
    assert tfa.flash_fwd.launches - flash0 == cfg.num_layers
    assert tda.decode_attention.launches - decode0 == 3 * cfg.num_layers


def test_value_guided_rollout_on_card_matches_cpu(cuda):
    """The fused actor end to end through both kernels (two trunks, twin Q,
    constrained vocab, sampled; f32 at tiny width): the card and the CPU
    give the same episodes under the same noise."""
    from lmrl_gym_torch.envs.wordle.vector import WordleVectorEnv, WordleVocab
    from lmrl_gym_torch.loops import actor
    from lmrl_gym_torch.models.heads import MLPHead, MLPHeadConfig
    from lmrl_gym_torch.models.interface import LMCore

    cfg = tiny_test_config(max_position_embeddings=actor.EPISODE_LEN)
    B, vocab = 4, WordleVocab.from_file()
    head_cfg = MLPHeadConfig(cfg.hidden_size, 2 * cfg.hidden_size, cfg.padded_vocab_size)
    params = {
        "pi_beta": Transformer(cfg, device="cpu", seed=0),
        "base": Transformer(cfg, device="cpu", seed=1),
        "q1": MLPHead(head_cfg, device="cpu", seed=2),
        "q2": MLPHead(head_cfg, device="cpu", seed=3),
    }
    g = torch.Generator().manual_seed(0)

    def gumbel(*shape):
        return -torch.log(-torch.log(torch.rand(*shape, generator=g).clamp(min=1e-30)))

    noise = actor.WordleNoise(
        decode=gumbel(actor.N_TRIES, 10, B, cfg.padded_vocab_size), env=gumbel(actor.N_TRIES, B, len(vocab))
    )
    outs = []
    for d in ("cuda", "cpu"):
        step_fn, carry = actor.make_value_guided_step_fn(LMCore(cfg, device=d), B, two_trunks=True, twin_q=True)
        flash0, decode0 = tfa.flash_fwd.launches, tda.decode_attention.launches
        out = actor.rollout_wordle(
            WordleVectorEnv(vocab, device=d), step_fn, {k: m.to(d) for k, m in params.items()}, carry, B,
            constrain_vocab=True, noise=actor.WordleNoise(noise.decode.to(d), noise.env.to(d)),
        )
        launches = (tfa.flash_fwd.launches - flash0, tda.decode_attention.launches - decode0)
        assert launches == ((7 * 2 * cfg.num_layers, 60 * 2 * cfg.num_layers) if d == "cuda" else (0, 0))
        outs.append(out)
    for f in ("tokens", "turn_reward", "turn_live", "win", "n_turns"):
        assert torch.equal(getattr(outs[0], f).cpu(), getattr(outs[1], f)), f


def _tiny_ilql_state(device):
    """The same seeded weights on either device (made on the CPU, moved)."""
    from lmrl_gym_torch.algos.ilql import ILQLConfig, init_ilql_state
    from lmrl_gym_torch.core.optimizer import adamw
    from lmrl_gym_torch.models.heads import MLPHead, MLPHeadConfig

    cfg = tiny_test_config()
    q = MLPHeadConfig(cfg.hidden_size, 2 * cfg.hidden_size, cfg.padded_vocab_size)
    v = MLPHeadConfig(cfg.hidden_size, 2 * cfg.hidden_size, 1)
    modules = (Transformer(cfg, device="cpu", seed=0), MLPHead(q, device="cpu", seed=1),
               MLPHead(q, device="cpu", seed=2), MLPHead(v, device="cpu", seed=3))
    state = init_ilql_state(*(m.to(device) for m in modules), adamw(1e-4), adamw(1e-3), ILQLConfig(polyak_alpha=0.1))
    return cfg, state


def _ilql_batch(device, B=4, T=40, nt=8):
    from lmrl_gym_torch.algos.ilql import ILQLBatch

    g = torch.Generator().manual_seed(0)
    ids = torch.randint(1, 256, (B, T), generator=g)
    ids[1, T - 5:] = 256  # right padding
    sta = torch.rand(B, T - 1, generator=g) < 0.4
    sta[:, 0] = True
    batch = ILQLBatch(ids, sta, -1.0 * sta.float(), torch.tensor([True, False, True, False]),
                      torch.randint(1, 256, (B, nt), generator=g), torch.tensor([True, False, False, True]))
    return ILQLBatch(*(t.to(device) for t in batch))


def test_ilql_step_on_card_matches_cpu(cuda):
    """A tiny-width ILQL step: the card (K1 + K2 + K3) against the CPU
    (plain versions), f32. Loss and logs within 1e-5 relative, each
    parameter group's gradient within 1e-4 in relative norm; then three
    full steps, parameters elementwise within 2e-6 + 1e-4·|p|, except where
    the first gradient is rounding noise (below 1e-5 of its tensor's
    largest: the key part of the qkv bias, whose gradient is zero in exact
    arithmetic), since Adam scales noise to ±lr steps on either side."""
    from lmrl_gym_torch.algos.ilql import ILQLConfig, ilql_loss_and_grads, make_ilql_train_step
    from lmrl_gym_torch.models.interface import LMCore

    runs = []
    for d in ("cuda", "cpu"):
        cfg, state = _tiny_ilql_state(d)
        core, batch = LMCore(cfg, device=d), _ilql_batch(d)
        counts0 = (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
        loss, logs, grads = ilql_loss_and_grads(core, state, batch, ILQLConfig(polyak_alpha=0.1), 256)
        counts = tuple(c - c0 for c, c0 in zip((tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches), counts0))
        L = cfg.num_layers
        assert counts == ((3 * L, L, L) if d == "cuda" else (0, 0, 0))
        step = make_ilql_train_step(core, ILQLConfig(polyak_alpha=0.1), 256)
        for _ in range(3):
            state, _, _ = step(state, batch)
        runs.append((loss.cpu(), logs["losses"], [{k: g.cpu() for k, g in gr.items()} for gr in grads], state))
    (l0, logs0, g0, s0), (l1, logs1, g1, s1) = runs
    assert abs(l0.item() - l1.item()) <= 1e-5 * abs(l1.item())
    for k in logs1:
        assert abs(logs0[k].item() - logs1[k].item()) <= 1e-5 * max(abs(logs1[k].item()), 1e-3), k
    for ga, gb in zip(g0, g1):
        for k in gb:
            assert (ga[k] - gb[k]).norm() <= 1e-4 * gb[k].norm() + 1e-8, k
    for a, b, grads in ((s0.base.params, s1.base.params, g1[0]), (s0.q1_target_params, s1.q1_target_params, g1[1])):
        for (k, ta), tb in zip(a.state_dict().items(), b.state_dict().values()):
            noise = grads[k].abs() <= 1e-5 * grads[k].abs().max()
            apart = (ta.cpu() - tb).abs() > 2e-6 + 1e-4 * tb.abs()
            assert not (apart & ~noise).any(), k


def test_bc_step_on_card_matches_cpu(cuda):
    from lmrl_gym_torch.algos.bc import BCBatch, BCConfig, BCTrainState, bc_loss_and_grads
    from lmrl_gym_torch.core.optimizer import TrainState, adamw
    from lmrl_gym_torch.models.interface import LMCore

    cfg = tiny_test_config()
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(1, 256, (3, 48), generator=g)
    ids[0, 40:] = 256
    batch = BCBatch(ids, (torch.rand(3, 48, generator=g) < 0.5).int())
    cpu = Transformer(cfg, device="cpu", seed=4)
    out = []
    for d in ("cuda", "cpu"):
        model = Transformer(cfg, device=d)
        model.load_state_dict(cpu.state_dict())
        state = BCTrainState(TrainState(model, adamw(1e-3)))
        loss, _, grads = bc_loss_and_grads(LMCore(cfg, device=d), state, BCBatch(*(t.to(d) for t in batch)), BCConfig(), 256)
        out.append((loss.cpu(), {k: v.cpu() for k, v in grads.items()}))
    assert abs(out[0][0].item() - out[1][0].item()) <= 1e-5 * abs(out[1][0].item())
    for k, gb in out[1][1].items():
        assert (out[0][1][k] - gb).norm() <= 1e-4 * gb.norm() + 1e-8, k

