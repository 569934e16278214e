"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests import neither JAX nor the JAX package, so they also run where
only PyTorch is installed:

    python -m pytest tests/test_torch_kernels.py --noconftest -o addopts="" -q

Without a CUDA device every test here skips (the kernels have no CPU mode).
Tolerances, |kernel − plain| ≤ atol + rtol·|plain|: f32 atol 1e-4
(summation order only); bf16 atol 1e-2, rtol 2⁻⁶ — two bf16 ulps, since
both sides round the output (and the plain version its probabilities) to
bf16.
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


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = _randn(1, 2, 1, 24 + 4, dtype=torch.float32, seed=0)  # Dh = 28: not a multiple of 8
    with pytest.raises(ValueError):
        tfa.flash_fwd(q, q, q)
    q, k = _randn(1, 2, 2, 64, dtype=torch.float32, seed=0), _randn(1, 2, 8, 64, dtype=torch.float32, seed=1)
    with pytest.raises(ValueError):
        tda.decode_attention(q, k, k, 3)  # two queries
    with pytest.raises(TypeError):
        tfa.flash_fwd(q.half(), k.half(), k.half())


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
