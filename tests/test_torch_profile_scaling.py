"""The port's profile and scaling scripts (`lmrl_gym_torch/scripts/
{profile_ilql,scaling}.py`), on the CPU.

(c) `counted_flops` of one ILQL step at d64 L2 H4 equals an independent
    count: every matmul of the trunk, the heads and the attention
    enumerated below as integers (the attention at the kernels' work
    formulas: 4·Dh per visible (query, key) pair forward, 6·Dh for K2 and
    8·Dh for K3).
(d) `_kernel_category` maps every kernel of the port's csrc/ and the GEMM,
    foreach, elementwise and reduce kernels that PERF.md §5 reports to its
    category.
(e) `collective_census` at d64 L2 on gloo ranks: no collective at
    (1, 1, 1) in a one-rank group; at (2, 1, 1) and (1, 2, 1) on two ranks
    (one group for both) the counts and output bytes that the port's FSDP2
    lowering implies, derived below from the units and their passes.
(f) Each `main` with `--device cpu` at a small size prints JSON that
    parses; without it, on a host with no CUDA device, it raises.
"""
import glob
import json
import os
import re

import pytest
import torch

from lmrl_gym_torch.parallel.launch import run_ranks
from lmrl_gym_torch.scripts import bench, profile_ilql, scaling
from test_torch_ppo_gate_parity import one_thread  # noqa: F401  (one intra-op thread for this module)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = dict(hidden_size=64, num_layers=2, num_heads=4, dtype="float32")
D, L, H = 64, 2, 4


def _pairs(T: int) -> int:
    return T * (T + 1) // 2  # causal (query, key) pairs of a T-token window


def test_counted_flops_equals_the_enumerated_matmuls():
    config = bench.ilql_config(259, 64).replace(**WIDTH)
    V, B, T, NT = config.padded_vocab_size, 4, 16, bench.NEXT_T
    state, step, batch = bench.ilql_setup(config, B, T, 256, "cpu")
    got = profile_ilql.counted_flops(step, state, batch, config)

    layer = 2 * D * 3 * D + 2 * D * D + 2 * D * 4 * D + 2 * 4 * D * D  # qkv, out, fc, proj per token
    trunk = L * layer + 2 * D * V  # and the tied lm_head's logits (computed, unused)
    q_head = 2 * D * 2 * D + 2 * 2 * D * V
    v_head = 2 * D * 2 * D + 2 * 2 * D * 1
    forwards = trunk * (B * T + B * T + B * NT)  # trained, target and next-window trunks
    backward = 2 * L * layer * B * T  # input and weight gradients of the trained trunk's layers
    heads = 3 * (2 * q_head + v_head) * B * T + 2 * q_head * B * T + v_head * B  # q1/q2/v fwd+bwd, targets, v_final
    attention = L * B * H * (D // H) * (4 * (2 * _pairs(T) + _pairs(NT)) + (6 + 8) * _pairs(T))
    assert got == forwards + backward + heads + attention


CSRC_CATEGORIES = {
    "flash_fwd_kernel": "K1 flash_fwd (CUDA cores)",
    "flash_fwd_tc_kernel": "K1 flash_fwd (tensor cores)",
    "flash_fwd_tc_wide_kernel": "K1 flash_fwd (tensor cores, Dh > 128)",
    "flash_bwd_dq_kernel": "K2 flash_bwd_dq (CUDA cores)",
    "flash_bwd_dq_tc_kernel": "K2 flash_bwd_dq (tensor cores)",
    "flash_bwd_dq_tc_wide_kernel": "K2 flash_bwd_dq (tensor cores, Dh > 128)",
    "flash_bwd_dkv_kernel": "K3 flash_bwd_dkv (CUDA cores)",
    "flash_bwd_dkv_tc_kernel": "K3 flash_bwd_dkv (tensor cores)",
    "flash_bwd_dkv_tc_wide_kernel": "K3 flash_bwd_dkv (tensor cores, Dh > 128)",
    "decode_attn_kernel": "K4 decode_attn",
    "decode_attn_split_kernel": "K4 decode_attn (split)",
    "decode_attn_wide_kernel": "K4 decode_attn (wide)",
}
LIBRARY_CATEGORIES = {  # names the H100's profile of an ILQL step reported (cuBLAS, CUTLASS, ATen)
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel_"
    "_5x_cublas": "gemm f32",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x256_8x4_nt_align1>(cutlass_80_simt_sgemm_128x256_8x4_nt_align1::"
    "Params)": "gemm f32",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_"
    "cublas": "gemm bf16",
    "nvjet_tst_192x192_64x4_2x1_v_bz_coopB_TNT": "gemm bf16",
    "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::(anonymous namespace)::"
    "TensorListMetadata<2>, at::native::(anonymous namespace)::BinaryOpListAlphaFunctor<float, 2, 2, 0>, "
    "std::plus<float>, float>": "optimizer (foreach)",
    "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, std::array<char*, 1ul> >":
        "elementwise",
    "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::direct_copy_kernel_"
    "cuda(at::TensorIteratorBase&)>": "elementwise",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::func_wrapper_t<float, "
    "at::native::sum_functor<float, float, float>::operator()>, unsigned int, float, 4> >": "reduce",
    "void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float, float, float, at::native::(anonymous "
    "namespace)::LogSoftMaxForwardEpilogue>": "other",
}


def test_kernel_category_covers_csrc_and_the_library():
    names = set()
    for path in glob.glob(os.path.join(ROOT, "lmrl_gym_torch", "csrc", "*.cu")):
        with open(path) as f:
            names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(", f.read()))
    assert names == set(CSRC_CATEGORIES)
    for name, cat in CSRC_CATEGORIES.items():
        # as the profiler names them: a template's arguments and the signature
        assert profile_ilql._kernel_category(f"void {name}<64, 4>(float const*, float*, int)") == cat, name
        assert profile_ilql._kernel_category(name) == cat, name
    for name, cat in LIBRARY_CATEGORIES.items():
        assert profile_ilql._kernel_category(name) == cat, name


CENSUS_B, CENSUS_T = 8, 16


def _census_config():
    return scaling.default_config().replace(**WIDTH)


def test_no_collective_on_one_rank():
    with scaling.one_rank_group("cpu"):
        assert scaling._census_rank(_census_config(), [(1, 1, 1)], CENSUS_B, CENSUS_T, "cpu") == [{}]


def test_census_on_two_ranks():
    config = _census_config()
    V, P, world = config.padded_vocab_size, config.max_position_embeddings, 2
    # FSDP2's units: each trunk block, each trunk's root (wte, wpe, ln_f), each head (parameters, f32)
    block = 12 * D * D + 13 * D
    root = V * D + P * D + 2 * D
    q = D * 2 * D + 2 * D + 2 * D * V + V
    v = D * 2 * D + 2 * D + 2 * D + 1
    v_padded = v + 2 * D + 1  # dense2's [1, 2D] weight and [1] bias padded to 2 rows for 2 shards
    trained = 2 * block + root + 2 * q + v  # the units with a gradient: base trunk and q1, q2, v
    # the step's own gathers of its 12 loss inputs (gather_batch), each after a gather of its length
    b, t = CENSUS_B // world, CENSUS_T - 1
    inputs = 7 * b * t * 4 + b * 4 + 2 * b * t * V * 4 + b * t * 8 + b * t * 1  # f32 x7, v_final, q1/q2 logits,
    gathers = {"count": 24, "bytes": world * (inputs + 12 * 8)}  # input ids (int64), actions (bool as uint8)
    # (1, 2, 1): FSDP2 gathers a unit before each forward and again before
    # its backward: blocks 2 x 3 (trained: main and next window, backward)
    # + 2 x 1 (target); roots 3 + 1; q heads 2 x 2 (q1, q2) + 2 x 1 (their
    # targets); v 3 (main, v_final, backward). It reduce-scatters each
    # trained unit's gradient to the rank's half
    fsdp_gathers = 8 * block + 4 * root + 6 * q + 3 * v_padded
    want_fsdp = {
        "all-gather": {"count": 21 + gathers["count"], "bytes": 4 * fsdp_gathers + gathers["bytes"]},
        "reduce-scatter": {"count": 6, "bytes": 4 * (2 * block + root + 2 * q + v_padded) // world},
    }
    # (2, 1, 1): one shard per replica, so no gather or reduce-scatter; an
    # all-reduce of each trained unit's whole gradient over the replicas
    want_dp = {"all-gather": gathers, "all-reduce": {"count": 6, "bytes": 4 * trained}}
    got = run_ranks(scaling._census_rank, world, (config, [(2, 1, 1), (1, 2, 1)], CENSUS_B, CENSUS_T, "cpu"))
    assert got[0] == got[1] == [want_dp, want_fsdp]


def test_profile_main_on_the_cpu(monkeypatch, capsys, tmp_path):
    full = bench.ilql_config
    monkeypatch.setattr(bench, "ilql_config", lambda vocab, pad: full(vocab, pad).replace(**WIDTH))
    out = tmp_path / "profile.json"
    result = profile_ilql.main(["--device", "cpu", "--vocab", "259", "--batch", "2", "--seq", "8", "--reps", "1",
                                "--out", str(out)])
    printed = json.loads(capsys.readouterr().out)
    assert printed == result == json.loads(out.read_text())
    assert result["model"] == "d64 L2 H4 vocab259 B2 T8" and result["device"] == "cpu"
    assert result["profile"] == "not measured (cpu)" and result["peak_flops"] == bench.CPU_NOMINAL_FLOPS
    assert result["counted_flops"] > 0 and result["updates_per_s"] > 0 and result["counted_mfu_pct"] >= 0


def test_scaling_main_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(scaling, "default_config", lambda config=_census_config(): config)
    rows = scaling.main(["--device", "cpu", "--max-devices", "1"])
    printed = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert printed == [{**r, "backend": "gloo"} for r in rows]
    assert {r["workload"] for r in rows} == {"ilql_fixed_total_work", "ilql_collective_census"}  # no weak rows here
    ran = [r for r in rows if "not_run" not in r]
    assert [r.get("n_devices", 1) for r in ran] == [1, 1] and all(r["not_run"] == "one device"
                                                                   for r in rows if r not in ran)
    assert ran[0]["step_ms"] > 0 and ran[1]["mesh"] == "dp1 fsdp1 mp1" and ran[1]["census"] == {}


@pytest.mark.parametrize("script", [profile_ilql, scaling])
def test_main_refuses_a_host_without_cuda(script, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script.main([])
