"""Smoke test of lmrl_gym_torch on one CUDA card (an H100; the kernels
target sm_90a).

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. the card (`nvidia-smi` name and power limit) and the kernel build
   (`nvcc`, one process per source, all started together, from
   lmrl_gym_torch/csrc/), with the chess library (`g++`, from
   native/chess/chesscore.cpp) built beside them;
2. each CUDA kernel against its plain PyTorch version on the card, at the
   serving path's shapes (B=512, H=12, Dh=64) and, for the flash forward
   and backward kernels, the training shapes (B=32, H=12, T=160, Dh=64,
   with a left-padded and a right-aligned Tq < S case; the forward also at
   the next window's T=16), a ragged T=100 (and Tq=37 over S=100) and
   Dh=128 at B=4, H=32, T=160, in bf16 (the tensor-core variant of the
   forward and the backward) and f32 (their CUDA-core variant), with the
   max abs error, its tolerance (and on fully masked left-pad rows lse
   equal to the plain version's −0.7·f32max), the variant each launch
   took, and the kernel, plain and library
   (scaled_dot_product_attention, forward or backward, a yardstick the port
   never calls) times; the backward cases include the online train step's
   (B=64, H=12, T=128) and the gate's (B=512, H=4, T=128) shapes, the
   right-padded Text-Nav windows (B=32, T=640, H=12 and 4), and
   one bf16 case on right-padded windows whose pad rows keep a live
   cotangent, held against the plain version with P and dS rounded to
   bf16 (the kernels' arithmetic), its drift from the f32-P plain version
   printed;
2j. K1 and K4 at GPT-J-6B's head width (Dh = 256, H = 16), bf16, against
   their plain versions (`phase_gptj_kernel_checks`): K1 on its
   tensor-core route at the rollout's shapes (B=256: the header prefill
   Tq=S=8 and the appends Tq=10 over S=28..128 of a 128-slot cache) and
   the served Text-Nav prefill (B=16, Tq=S=640 of a 676-slot cache, with
   and without left padding), each with kernel, plain, SDPA and CUDA-core
   variant ms and the bound; K4 at indices 8, 67 and 127 (B=256) and at
   every third fill of the rollout and of the turn (B=16, left-padded),
   with kernel, plain and SDPA ms and the bound;
2p. K1 and K4 against their plain versions at the later paths' shapes,
   bf16: the online rollout (B=256, H=12) and the gate's evals (B=512,
   H=4) on cache views, the text env's and LMServer's left-padded prefill
   and decode with bias (B=8 and 4, prompts of 128 and 48 tokens; the
   Text-Nav rollouts' B=16, prompts of 640 and 36 new tokens); the Markov
   paths' (bf16): K1 on each turn's observation prefill (Tq = S = 20, 96,
   72 on views of 31-, 104- and 80-slot caches; B=512 and 256) and K4 at
   every action slot, and K1-K3 on their train windows (T = 104, 31, 80;
   B=64 and 512) with K1 alone on the next-window forward; and the dialog
   paths' (`_check_dialog_shapes`): the gates' f32 decoder oracle (d128 H4,
   Dh 32: 256 + 8 slots, B=100 and 16), LM buyer (d192 H4, Dh 48: 768 + 64,
   B=1) and policies (d256 H4: 768 + 48, B=16 and the reranker's 128), 3d's
   bf16 asker and decoder oracle (B=64), K1-K3 on the f32 train windows
   (256, 512, 768, 448; B=16) and K1 on the score calls (B=128, 768 and
   448), and the tensor-core variants at Dh 32 and 48 in bf16; at each f32
   dialog shape the CUDA-core routes are timed (K1 on the prefills and
   train windows, K4 at the middle new slot, K2 and K3 on the train
   windows) beside their bound (bytes, or FLOPs at the card's 67 TF/s f32
   rate outside the tensor cores), their plain versions and SDPA in f32
   with TF32 off; every K4 check also holds the route: the split route
   exactly where `_decode_splits` asks for one;
2s. K4's split route (Dh <= 128 below two blocks per SM: the keys cut into
   splits merged in one launch; `phase_split_checks`) against its plain
   version in f32 and bf16 at Dh 32, 48, 64 and 128, B x H from 1 to one
   below the threshold, indices 127, 128, 300 and 791 (across split
   boundaries) and left padding longer than a split, every launch on the
   split route; then its times (kernel, plain, SDPA, the bound) at a
   served Text-Nav turn (GPT-2-small, B=16, bf16, fills 640..675) and a
   text-env turn's decode (B=8, fills 128..137); 2j also times K1 at
   3jt's ILQL-step windows (B=32, T=160, Dh=256) beside its bound and SDPA;
3. serving at full width: value-guided Wordle serving with GPT-2-small
   (vocab 50,257 padded to 50,304), bf16 weights from a seed, two trunks,
   twin MLP Q heads, beta=32, constrained vocab, B=512 — one warm-up and two
   timed `rollout_wordle`s, each with the kernels' launch counts (every
   flash_fwd launch the tensor-core variant) and the rollout's invariants
   checked, and one more under torch.profiler for the
   device busy time, idle share and device time by kernel category; then
   `ValueGuidedServer.generate_from_strs` answers 4 left-padded prompts;
3b. the port's measurement scripts (`lmrl_gym_torch/scripts/{bench,
   profile_ilql,scaling}.py`): `bench.main` over all six sections at their
   operating points (BENCH_REPS=3 timed reps each; 3b's comment lists the
   cuts), every call's launches checked (each ILQL step 3L / L / L, each
   Wordle rollout 7L K1 and 60L K4, each Markov rollout 8L K1 and
   8·ACT_LEN·L K4, all on the tensor cores and none on K4's split route;
   bench_env none), each section's numbers on a line of their own;
   `profile_ilql.main` at its defaults (counted FLOPs and MFU, a profiled
   step by category) with its steps' launches checked, and its
   `counted_flops` on the card equal to the CPU's at the same config
   (B=2, T=32; the CPU's counted in a process started after phase 1);
   scaling's rows run in 3x;
3t. training at full width, at `bench.py::bench_ilql_real_vocab`'s
   operating point: the ILQL train step on GPT-2-small (f32 parameters,
   bf16 activations), twin MLP Q heads (hidden 1536, out 50,304) and a V
   head, a separate target base, AdamW, B=32, T=160, next window 16, on
   the JAX bench's batch — timed by 3b's `bench_ilql_real_vocab` (its
   warm-up and three timed steps, each with its launch counts (36
   flash_fwd, 12 flash_bwd_dq, 12 flash_bwd_dkv, every launch the
   tensor-core variant) and a finite loss checked there) and profiled by
   3b's `profile_ilql`; then three BC steps on the same trunk (12/12/12
   launches, the same check);
3o. on-device online ILQL at full width (`loops/online_device.py::
   online_ilql_wordle`): GPT-2-small with f32 parameters and bf16
   activations, twin MLP Q heads and a V head, a separate target base,
   AdamW, beta=32, `OnlineDeviceConfig()` cut to 2 rounds (of a B=256 one-trunk
   guided rollout on the live modules, then four B=64, T=128 train steps):
   per round the rollout's launches (84 flash_fwd, 720 decode_attn) and
   each step's (24 / 12 / 12), all on the tensor-core variants, the
   rollout's invariants, a finite loss, base weights that move between
   rounds, the rollout and train wall time per round and the peak memory;
   then the rollout and the round's train steps once more, each under
   torch.profiler;
3g. the port's Wordle ILQL gate (`lmrl_gym_torch/scripts/
   wordle_ilql_gate.py`) at its own width (d256, L4, H4, byte vocab 259
   padded to 320) and a cut budget (15 BC, 15 %BC, 15 ILQL steps, eval
   batch 512, no OptimalPolicy bound): every stage runs, its launch counts
   are the budget's, and every return is finite and in [-6, 0]; the gate
   draws the JAX gate's random stream (slice 18, `core/threefry.py`), so
   its behavior and ceiling statistics equal the four numbers of
   `GATE_WORDLE_ILQL_r05.json` exactly; then the stream itself: one ILQL
   batch's `ScriptedNoise` (B = 512) and one eval's `WordleNoise` (B =
   1,024) drawn on the card equal the CPU's draws (integers, uniforms and
   Gumbels to the bit, a Gumbel mismatch shown row by row; categorical
   picks over masked logits equal), the Gumbel table (all 2^23 values)
   equal, the gate's initial trunk and heads within 1e-6 of the CPU's,
   and the draw time per 512- and 2,048-episode batch;
3s. legal-set and text-env serving on the phase-3 weights: a
   `GenerationPolicy` over `ValueGuidedServer.generate_from_strs_legal`
   (the 400 vocab words as proposals) plays 8 `ReformatWordleEnv` games
   through `envs/base.py`'s interaction loop — every action a vocab word,
   every game over within 6 turns, 24 flash_fwd (left-padded, with bias)
   and 240 decode_attn launches per turn; then `LMServer.generate_from_strs`
   answers 4 prompts;
3m. the MC-returns train step at phase 3t's operating point (one MLP Q
   head): one warm-up, three timed steps with exact launch counts (12 / 12 /
   12, tensor cores) and finite losses, one profiled step; then one
   full-width f32 step on the card against the CPU (as phase 4's ILQL
   step);
3c. the CQL train step at the same point with a separate target base and
   a next window of 16 (36 / 12 / 12 per step), the same checks, its peak
   memory;
3p. one PPO round on the maze (`build_maze_env`, byte tokenizer, episodes
   cut to 8 moves) at GPT-2-small width over the byte vocab: 32 episodes
   at batch 16 through `GenerationPolicy` → `LMServer` → `text_env_eval`
   (12 K1 and 144 K4 launches per call), `get_ppo_data_from_chains`
   through `make_ppo_forward_fn` (24 K1 per call, finite KL and values),
   `block_ppo_data`, then two PPO steps at B=32 without the BC term (12 /
   12 / 12) and two with it (24 / 24 / 24), finite losses, moving weights;
3r. `ReRankerPolicy` over the maze's four move proposals in all 25 cells,
   scored at the same width by `make_ilql_score_fn` (twin Q and V: 12 K1
   per score call; with a π_β trunk and `logit_weight`: 24) and
   `make_mc_score_fn` (12): every action one of the proposals;
3z. the port's maze gate (`lmrl_gym_torch/scripts/maze_ilql_gate.py`) at
   its own width (d256 L4 H4, byte vocab) and a cut budget (50 chains, one
   BC epoch, two value epochs, legal-move guided decode), --algo cql then
   --algo mc: launch counts exactly the budget's, accuracies in [0, 1];
3n. one PPO round on Text-Nav at GPT-2-small width (d768 L12 H12) over
   the Text-Nav BPE (449 ids): 16 `TextNavEnv` episodes cut to 4 turns
   through the port's Text-Nav gate's windowed policy (prompts of up to
   640 tokens at H = 2, 36 new tokens; 12 K1 and 432 K4 launches per
   `LMServer` call), `get_ppo_data_from_chains` on 640-token windows (24
   K1 per forward call), four PPO steps at B=32 (12 / 12 / 12; the last
   with the BC term, 24 / 24 / 24), finite losses, moving weights; a turn
   and two steps profiled;
3l. the generic loops at full width: `offline_train_loop` drives phase 3t's
   ILQL step (one B=32 batch per epoch) for two epochs, saving the
   seven-module checkpoint with its optimizer state after each; a fresh
   state restored from the first resumes the loop, and its first step's
   loss equals the uninterrupted run's second within 1e-6 relative; the
   checkpoint's write and read seconds and bytes; then `online_train_loop`
   runs two maze PPO rounds (phase 3p's width) with a round checkpoint;
   all checkpoints in a temporary directory, deleted afterwards;
3w. the port's two PPO gates (`lmrl_gym_torch/scripts/{text_nav,maze}_
   ppo_gate.py`) at their own width (d256 L4 H4) and a cut budget (two
   rounds, the first a value warm-up; maze episodes of at most 20
   moves): launch counts exactly the budget's
   (per `LMServer` call, BC and PPO step, PPO forward call) and every
   return inside its env's range;
3k. (run in 3b) the Markov actors at `bench.py::bench_actor_markov`'s
   point, 3b's `bench_actor_markov`: GPT-2-small over a 512-token vocab,
   bf16 weights from a seed, `rollout_markov` through `make_lm_step_fn`,
   B=512, 8 turns, on the maze (double_t_maze, 8 moves) and KQ-K chess
   (FEN, 8 moves): one warm-up and three timed rollouts each with exact
   launches (K1 8 x 12 = 96; K4 8 x 11 x 12 = 1,056 maze, 8 x 8 x 12 = 768
   chess), turns that never come back to life, rewards in {0, -1, -4} /
   {1, 0, -1} and every chess frame's FEN valid for the port's engine,
   env-steps/s, one more rollout each profiled;
3u. `online_ilql_markov` on chess at full width (f32 parameters, bf16
   activations, twin MLP Q heads and a V head, a separate target base, a
   frozen pi_beta), two rounds of a B=256 rollout and B=64 steps: per
   round the rollout's launches (192 / 1,536; the two-trunk value-guided
   chess rollout, the online loop's and the gate's step function) and
   each step's (36 / 12 / 12), finite losses, moving weights, wall times,
   a rollout and two of a round's steps profiled;
3h. the port's chess gate (`lmrl_gym_torch/scripts/chess_ilql_gate.py`)
   at its own width (d256 L4 H4, grid observations) and a cut budget:
   launch counts exactly the budget's and every rate in [0, 1];
3q. runs that repeat (slice 14): every variant and route of K1-K4 (the
   tensor-core, wide Dh = 256 and f32 CUDA-core K1-K3, the f32 K1 at the
   dialog policy's and oracle's prefills; K4's common, Dh > 128 and split
   routes and f32) launched twice on the same inputs at a serving and a
   training shape; three ILQL steps at 3t's point, 3p's first PPO
   step and two steps of `lm_oracle.train_t5_oracle_lm` at 3d's check
   width, each run twice from its seeds; the Wordle gate's JAX-stream
   draws (3g's ILQL batch and eval noise) twice; and 3h's cut chess gate again in
   a subprocess with another PYTHONHASHSEED. Every comparison is exact
   (torch.equal; the gate's result JSON key for key): the port's card
   settings (`core/device.py::resolve_device`) make a seeded run repeat
   to the bit;
3d. the LM-oracle dialog stack at full width, the reference's own 20Q
   configuration: a GPT-2-small asker (bf16, over the 20Q task BPE, 822
   ids padded to 896; sampled through `GenerationPolicy` over `LMServer`,
   prompts to 768 tokens, 48 new) against a flan-t5-xl-width T5 oracle
   (d2048, 24 + 24 layers, 32 heads, gated-gelu, untied; bf16 weights from
   a seed; `Seq2SeqServer`, 256-token right-padded encoder inputs, 8 new
   tokens, greedy) in `BatchedTwentyQuestionsEnv`, B=64, 2 env turns; then
   the same turns against a GPT-2-small decoder oracle (`LMServer`); per
   turn exact launches (asker 12 K1 and 576 K4; decoder oracle 12 and 96;
   the T5 none), every answer 'Yes.' or 'No.', every live history one
   question and one answer longer; the median turn split between asker and
   oracle; a profiled T5 turn by device category, the T5's attention cores
   and f32 lm_head timed on their own; and the T5 at 2 + 2 layers, bf16 on
   the card against f32 on the CPU (relative RMS error within twice the
   CPU's own bf16 error on the same weights and inputs);
3e. the port's three dialog gates (`lmrl_gym_torch/scripts/{car_dealer_
   ilql,dialog_ilql,twenty_questions}_gate.py`) at their own widths (f32)
   and a cut budget (a few dozen episodes, one epoch per stage, episodes
   of at most 3 turns, 64 balanced oracle QA windows): launch counts exactly the budget's (counted from the
   serving calls, score calls and train steps each gate makes), finite
   losses, rewards in the env's range and fidelities in [0, 1];
3i. the command line at full width (slice 10): `lmrl_gym_torch.cli.train`
   runs ILQL on Wordle at GPT-2-small with the full 50,257-id vocabulary
   (padded to 50,304) over the task BPE, with the size's default dropout
   (attention-probability dropout 0.1 among it): 64 behavior episodes,
   four B=16 steps, one eval of 8 value-guided games, the JAX package's
   seven-module checkpoint layout; launches exact (the trained steps none:
   attention dropout takes the einsum route; L K1 and 32·L K4 per guided
   serving call); `cli.evaluate` reads the checkpoint and reproduces the
   eval's reward; the trained base through `export_hf_pretrained` and
   `load_hf_pretrained` with `transformers` and `safetensors` blocked,
   to bit-identical logits; one attention-dropout training forward (f32,
   B=16, T=160, keep masks replayed) on the card against the CPU;
3x. the sharded code in a one-rank NCCL group (slice 11): phase 3t's ILQL
   step built by the port's scaling script (`scaling._make_ilql_setup`:
   `load_mesh((1, 1, 1))`, FSDP2 on all seven modules by their rule
   tables) beside the unsharded step from the same weights and batch, launches exact (36 / 12 / 12, tensor cores), the largest loss
   and parameter difference printed (held to 1e-6), both steps' times and
   device busy time, the sharded step's NCCL kernels and FSDP2 events; the
   V head's sharded train-state write byte-identical to the unsharded
   write and its stream-sharded read; ring attention over a one-rank sp
   mesh at the Text-Nav windows' shapes against K1 (`phase_sharded`); then
   the port's `scaling.main` rows in the same group (`_scaling_rows`): the
   n = 1 rows measured (env and ILQL weak scaling, fixed total work, the
   (1, 1, 1) collective census, empty), each step's launches checked, every
   n > 1 row marked not run on one card;
3j. GPT-J-6B's value-guided serving at full width and depth (slice 12;
   `gptj_6b`: vocab 50,400 padded to 50,432, 28 layers, d 4096, 16 heads
   of 256, rotary_dim 64 interleaved, parallel FFN, untied lm_head; bf16
   weights from a seed): two trunks, twin MLP Q heads (f32, hidden 8,192),
   beta=32. The fused Wordle rollout at B=256 on the constrained vocab —
   one warm-up, two timed with exact launches (K1 392, all on the tensor
   cores; K4 3,360), its invariants, env-steps/s, tokens/s and peak
   memory, one profiled by kernel category — then, its caches freed, a
   served Text-Nav turn (`ValueGuidedServer.generate_from_strs`, B=16
   `TextNavEnv` histories left-padded or cut to 640 byte tokens, 36
   sampled new tokens; K1 56 and K4 2,016), one warm-up and two timed;
   and the trunk cut to 2 layers at full width, bf16 on the card against
   f32 on the CPU (logits within LOGIT_TOL; `phase_gptj`);
4. the same full-width serving weights at B=4 on the card (kernels, bf16)
   against the CPU (plain path, f32): header prefill plus 3 decode steps;
   and one full-width ILQL step (f32, B=2, T=32) on the card against the
   CPU: loss within 1e-4 relative, each parameter group's gradient within
   1e-3 in relative norm, no launch on the tensor-core variant;
3a. configs whose attention the kernels refuse, run last:
   no earlier path reached the model's einsum route
   (`attention_einsum.calls`, never reset before this phase, is 0, and every
   launch-count reset checks it too); then GPT-2-small cut to 2 layers with
   a head dim of 28 (hidden 224 over 8 heads, f32) and with float16
   activations, each through `Transformer.forward` on the card against the
   CPU: a no-cache forward, a left-padded cached prefill, three 1-token
   steps and an append, every call L einsum calls and no K1 or K4 launch,
   logits within the f32 tolerance (Dh 28) or LOGIT_TOL (float16 against
   the CPU's f32); the Dh 28 model's training gradient within
   STEP_GRAD_RTOL of the CPU's, no K2 or K3 launch; and K1's wrapper,
   called directly, still refuses both;
5. a `{"kernels": [...]}` line: per kernel its launches on its path (per
   rollout, or per train step) and its mean time per launch over that
   path's shapes beside the bound (bytes or FLOPs at the H100's published
   peaks), the plain version's and the library call's; for flash_fwd also
   the CUDA-core variant's time on the same shapes (`simt_ms`), the
   kernel the tensor-core one replaced there. flash_fwd runs on
   both paths: its main keys are the rollout's, and the `*_train_step`
   keys the same numbers for one ILQL train step; `launches_<path>` are
   the counts recorded on each later path (the online round and step, the
   Wordle gate, a text-env turn, an MC, CQL and PPO step, a PPO forward
   call and rollout turn, a score call, the cut maze gates; and slice 7's: a Text-Nav turn, PPO forward
   call and step (with BC), an offline and an online loop step, the cut
   PPO gates; and slice 8's: a Markov rollout on the maze and on chess,
   the guided chess rollout (3u's), an online Markov round and step, the cut
   chess gate; and slice 9's: a 3d asker turn and decoder-oracle turn, the
   three cut dialog gates; and slice 10's: the 3i train CLI run and the
   evaluate CLI run; slice 11's sharded step; and slice 12's GPT-J rollout
   and Text-Nav turn, with K1's and K4's per-launch means over those
   paths' Dh = 256 shapes from 2j under `*_gptj_rollout` and
   `*_gptj_turn`). Every kernel with two
   variants carries the `variant` its main path runs and its `tc_launches`; and beside SDPA's backward
   (`library_ms`, which computes its own rowsum(dO ⊙ O)) the port's Δ pass
   (`delta_ms`) and the pair plus Δ (`pair_plus_delta_ms`); and per kernel
   `f32_dialog`, 2p's timings of its CUDA-core route at the f32 dialog
   shapes, and `f32_dialog_loss_ms`, the cut dialog gates' launches times
   the mean (kernel − bound) ms over those shapes (the ranking a kernel
   redesign is chosen by); for decode_attn `split_launches` (the serving
   rollout's: none), `split_launches_<path>` on each later path and their
   sum, and 2s's rows under `*_text_nav_turn` and `*_text_env_turn`; for
   flash_fwd 2j's row at 3jt's ILQL step under `*_gptj_train_step`.

The last line is `{"ok": true, "device": {...}}`. Without a CUDA device the
script exits 2 and prints no result.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np
import torch

from lmrl_gym_torch.algos.bc import BCBatch, BCConfig, BCTrainState, make_bc_train_step
from lmrl_gym_torch.algos.data import ArrayDataset
from lmrl_gym_torch.algos.cql import CQLConfig, cql_forward, init_cql_state, make_cql_train_step
from lmrl_gym_torch.algos.ilql import (
    ILQLBatch,
    ILQLConfig,
    ilql_loss_and_grads,
    init_ilql_state,
    make_ilql_train_step,
)
from lmrl_gym_torch.algos.mc import MCBatch, MCConfig, MCTrainState, make_mc_train_step, mc_loss_from_params
from lmrl_gym_torch.algos.ppo import (
    PPOBatch,
    PPOConfig,
    PPOTrainState,
    block_ppo_data,
    get_ppo_data_from_chains,
    make_ppo_forward_fn,
    make_ppo_train_step,
)
from lmrl_gym_torch.algos.value_policy import (
    GenerationPolicy,
    LMServer,
    ReRankerPolicy,
    ValueGuidedServer,
    ValueRLParams,
    make_ilql_score_fn,
    make_mc_score_fn,
    tokenize_histories_for_scoring,
)
from lmrl_gym_torch.cli.tasks import build_maze_env, generate_maze_chains
from lmrl_gym_torch.core import threefry
from lmrl_gym_torch.core.blocking import BlockingStrategy, Padding, Truncation
from lmrl_gym_torch.core.device import resolve_device, torch_dtype
from lmrl_gym_torch.core.optimizer import TrainState, adamw, set_to_zero, value_and_grads
from lmrl_gym_torch.envs import lm_oracle
from lmrl_gym_torch.envs.base import text_env_eval
from lmrl_gym_torch.envs.chess import engine as chess_engine
from lmrl_gym_torch.envs.maze.eval import per_cell_optimal_move_accuracy
from lmrl_gym_torch.envs.maze.grids import ACTION_STRS, double_t_maze
from lmrl_gym_torch.envs.maze.vector import MazeTokenVecEnv
from lmrl_gym_torch.envs.text_nav.env import TextNavEnv, WalkthroughAgent
from lmrl_gym_torch.envs.wordle.env import ReformatWordleEnv, WordleEnv
from lmrl_gym_torch.envs.wordle.vector import N_TRIES, WordleVectorEnv, WordleVocab
from lmrl_gym_torch.loops import actor, online_device
from lmrl_gym_torch.loops import checkpoints as loop_checkpoints
from lmrl_gym_torch.loops.checkpoints import LoopState, restore_module
from lmrl_gym_torch.loops.offline import OfflineLoopConfig, offline_train_loop
from lmrl_gym_torch.loops.online import OnlineLoopConfig, online_train_loop
from lmrl_gym_torch.loops.online_device import (
    OnlineDeviceConfig,
    markov_rollout_to_ilql_batch,
    online_ilql_markov,
    online_ilql_wordle,
    wordle_rollout_to_ilql_batch,
)
from lmrl_gym_torch.envs.lm_oracle import build_lm_twenty_questions_env
from lmrl_gym_torch.models.config import gpt2_small, gptj_6b
from lmrl_gym_torch.models.encdec import EncDecCore, EncoderDecoder, T5Attention, flan_t5_xl
from lmrl_gym_torch.models.generation import SamplingConfig
from lmrl_gym_torch.models.heads import LinearHead, LinearHeadConfig, MLPHead, MLPHeadConfig, head_from_key
from lmrl_gym_torch.models.interface import LMCore
from lmrl_gym_torch.models.transformer import KVCache, Transformer, attention_einsum, init_params, init_params_from_key
from lmrl_gym_torch.ops import _build
from lmrl_gym_torch.ops import flash_attention as flash_module
from lmrl_gym_torch.ops.decode_attention import _decode_splits, _device_sms, _plain_decode_attention, decode_attention
from lmrl_gym_torch.ops.flash_attention import (
    _NEG_BIG,
    _delta,
    _plain_attention,
    _plain_bwd_dkv,
    _plain_bwd_dq,
    _plain_dscores,
    _variant,
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_fwd,
    kernels_take,
)
from lmrl_gym_torch.scripts import (
    car_dealer_ilql_gate,
    chess_ilql_gate,
    dialog_ilql_gate,
    maze_ilql_gate,
    maze_ppo_gate,
    profile_ilql,
    scaling,
    text_nav_ppo_gate,
    twenty_questions_gate,
    wordle_ilql_gate,
)
from lmrl_gym_torch.scripts import bench as port_bench
from lmrl_gym_torch.scripts.bench import PEAK_FLOPS, ilql_update_flops
from lmrl_gym_torch.scripts.profile_ilql import (
    PROFILER_TRIES,
    _kernel_category,
    bwd_work,
    device_kernel_times,
    flash_work,
)
from lmrl_gym_torch.text.frames import (
    Text,
    TextTrajectory,
    TextTrajectoryChain,
    TokenTrajectoryChain,
    text_history_to_str,
)
from lmrl_gym_torch.text.bpe import train_bpe_for_task
from lmrl_gym_torch.text.tokenizer import ByteTokenizer

# H100 SXM published HBM rate (NVIDIA data sheet, at the 700 W limit); the
# dense peaks are the port bench's PEAK_FLOPS
HBM_BYTES_PER_S = 3.35e12

B, H, DH, T_MAX = 512, 12, 64, actor.EPISODE_LEN
GPTJ_H, GPTJ_DH = 16, 256  # GPT-J-6B's heads and head width (phases 2j, 3j)
# kernel vs plain: |kernel − plain| ≤ atol + rtol·|plain|. f32: summation
# order only. bf16: two bf16 ulps, since both round the output (and the
# plain version its probabilities) to bf16.
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-2, 2.0**-6)}
# backward kernels vs plain: f32 adds 1e-5 relative (dK sums up to 160
# query rows); bf16 as the forward
GRAD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 2.0**-6)}
# card (bf16 weights/activations, kernels) vs CPU (f32, plain path) logits
# after 12 layers: bf16 keeps ~3 significant digits per op, logits ~ ±3
LOGIT_TOL = 0.1
ROLLOUT_REPS = 1  # timed rollouts; the median is reported beside min and max
ONLINE_ROUNDS = 2  # 3o's rounds (the config's default is 4)
SPIN_CYCLES = 10_000_000  # cuda_ms's head start for the host: ~5 ms at the H100's 1.98 GHz boost
# training: bench.py::bench_ilql_real_vocab's operating point
TRAIN_B, TRAIN_T, NEXT_T = 32, 160, 16
PAD_ID = 50256  # as bench.py passes it (no batch token is a pad)
# card vs CPU ILQL step in f32 at full width: TF32 is off, so only the
# summation order differs (~1e-6 relative per op)
STEP_LOSS_RTOL, STEP_GRAD_RTOL = 1e-4, 1e-3
# the maze paths: windows and prompts blocked to 160 tokens (the maze
# gate's MAX_LEN), 12 new tokens per action
MAZE_LEN, MAZE_NEW = 160, 12
TN_LEN, TN_NEW = 640, 36  # the Text-Nav gate's windows at H = 2 (384 + 128·2) and new tokens per action


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean ms per call over `reps` back-to-back calls, by CUDA events. A
    spin kernel (~5 ms) runs first, so the host has queued the calls
    before the device reaches them: a call whose host work outlasts its
    kernels (a wrapper around a 20 µs kernel) is timed by its kernels."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20) -> float:
    """Mean device time per call: the sum of the device times of the
    kernels `reps` calls launch, under torch.profiler. For calls whose host
    work outlasts their device work (autograd around a small library
    kernel), where CUDA events would time the host."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in kernels) / 1e3
        if total > 0:
            return total / reps
    log(f"the profiler recorded no device time in {PROFILER_TRIES} tries; timing with CUDA events instead")
    return cuda_ms(fn, reps)


def excess(out, ref, dtype):
    """Elementwise |out − ref| − rtol·|ref|, to hold against atol."""
    return (out.float() - ref.float()).abs() - TOL[dtype][1] * ref.float().abs()


def bound_ms(n_bytes: float, flops: float, dtype) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else "operations")


def decode_work(b: int, h: int, dh: int, n_keys: int, dtype) -> tuple:
    """Bytes and FLOPs of one decode step of shape (b, h, dh) over n_keys
    cache slots, no bias."""
    es = torch.finfo(dtype).bits // 8
    n_bytes = es * b * h * dh * (2 + 2 * n_keys)
    return n_bytes, 4.0 * b * h * dh * n_keys


@contextlib.contextmanager
def forced_variant(variant: str):
    """K1-K3 launch `variant` whatever `_variant` picks: times the
    CUDA-core forward that the tensor-core one replaced on the main paths,
    in the same run and on the same inputs."""
    picked = flash_module._variant
    flash_module._variant = lambda dtype, head_dim, name: variant
    try:
        yield
    finally:
        flash_module._variant = picked


def sdpa_mask(bias, Tq: int, S: int, b: int = B):
    """Boolean [b,1,Tq,S] mask (True = attend) for the library yardstick."""
    q_pos = torch.arange(Tq, device="cuda") + (S - Tq)
    mask = (q_pos[:, None] >= torch.arange(S, device="cuda")[None, :])[None, None]
    if bias is not None:
        mask = mask & (bias == 0)[:, None, None, :]
    return mask.expand(b, 1, Tq, S)


def sdpa_bwd_ms(q, k, v, bias, dout, scale: float, causal_only: bool, reps: int = 20) -> float:
    """The library yardstick for K2 + K3 together: scaled_dot_product_attention's
    backward, timed as device time of (forward + backward) − forward."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    Tq, S = q.shape[2], k.shape[2]
    kw = dict(is_causal=True) if causal_only else dict(attn_mask=sdpa_mask(bias, Tq, S, q.shape[0]))
    with torch.enable_grad():
        t_fb = device_ms(lambda: torch.autograd.grad(sdpa(qs, ks, vs, scale=scale, **kw), (qs, ks, vs), dout), reps)
        t_f = device_ms(lambda: sdpa(qs, ks, vs, scale=scale, **kw), reps)
    return t_fb - t_f


def phase_device() -> str:
    # the port's card settings (no TF32, deterministic algorithms) for all
    # of the script's work on the card, as every entry point sets them
    resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    chess_build = {}
    # the chess library (g++) builds beside the kernels (one nvcc per source)
    chess_thread = threading.Thread(target=lambda: chess_build.update(path=chess_engine.build(),
                                                                      s=time.perf_counter() - t0))
    chess_thread.start()
    reports = _build.build_all(["flash_fwd", "flash_fwd_tc", "flash_bwd", "flash_bwd_tc", "decode_attn"])
    log(f"kernel build: {time.perf_counter() - t0:.2f} s for {sorted(reports) or 'nothing (cached)'}")
    chess_thread.join()
    check("path" in chess_build, "the chess library did not build")
    log(f"chess library build (g++ {' '.join(chess_engine.CXX_FLAGS)}): {chess_build['s']:.2f} s, {chess_build['path']}")
    for name, report in sorted(reports.items()):
        for line in report.splitlines():
            if "Compiling entry function" in line:
                log(f"  ptxas {name}: {line.split(chr(39))[1][:110]}")  # the mangled kernel name
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {name}:   {line.strip()}")
    return card


def _flash_inputs(Tq, S, dtype, padded, gen, b=B, h=H, t_max=None, dh=DH):
    """q [b,h,Tq,dh], k/v [b,h,S,dh] and a left-pad bias [b,S]; with
    `t_max`, as the cached trunk passes them: q a view into the fused
    [b,Tq,3·h·dh] projection, k/v the filled prefix of a [b,h,t_max,dh]
    cache and the bias the prefix of a [b,t_max] one."""
    if t_max is None:
        q = torch.randn(b, h, Tq, dh, device="cuda", generator=gen).to(dtype)
    else:
        q = torch.randn(b, Tq, 3, h, dh, device="cuda", generator=gen).to(dtype)[:, :, 0].transpose(1, 2)
    k = torch.randn(b, h, t_max or S, dh, device="cuda", generator=gen).to(dtype)[:, :, :S]
    v = torch.randn(b, h, t_max or S, dh, device="cuda", generator=gen).to(dtype)[:, :, :S]
    bias = None
    if padded:
        n_pad = torch.randint(0, S, (b,), device="cuda", generator=gen)
        pos = torch.arange(t_max or S, device="cuda")[None, :]
        bias = torch.where(pos >= n_pad[:, None], 0.0, _NEG_BIG).float()[:, :S]
    return q, k, v, bias


def _decode_inputs(index, dtype, padded, gen, b=B, h=H, t_max=T_MAX, max_pad=None, dh=DH):
    q = torch.randn(b, h, 1, dh, device="cuda", generator=gen).to(dtype)
    k = torch.randn(b, h, t_max, dh, device="cuda", generator=gen).to(dtype)
    v = torch.randn(b, h, t_max, dh, device="cuda", generator=gen).to(dtype)
    bias = None
    if padded:  # key `index` stays visible
        n_pad = torch.randint(0, min(index, max_pad or index) + 1, (b,), device="cuda", generator=gen)
        bias = torch.where(torch.arange(t_max, device="cuda")[None, :] >= n_pad[:, None], 0.0, _NEG_BIG).float()
    return q, k, v, bias


def _check_decode(q, k, v, index, bias, dtype, label: str) -> float:
    """decode_attention against _plain_decode_attention within TOL, on the
    route `_decode_splits` picks (the split route below two blocks per SM
    with 128 keys or more at Dh <= 128); returns the max abs error."""
    scale = 1.0 / q.shape[-1]**0.5
    split0 = decode_attention.split_launches
    out = decode_attention(q, k, v, index, bias, scale)
    n_split = decode_attention.split_launches - split0
    ref = _plain_decode_attention(q, k, v, index, bias, scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    check(excess(out, ref, dtype).max().item() <= TOL[dtype][0], f"decode_attn {label} {dtype}: max abs err {err}")
    b, h, _, dh = q.shape
    want = int(_decode_splits(b, h, dh, index + 1, _device_sms(q.device)) > 1)
    check(n_split == want, f"decode_attn {label} {dtype}: {n_split} split-route launches, want {want}")
    return err


def _check_fwd(q, k, v, bias, rows, dtype, label: str) -> tuple:
    """flash_fwd against _plain_attention on the same inputs: out within
    TOL and lse within 1e-3 on the query rows that see a key (`rows`,
    [b, Tq]; the outputs of fully padded rows hold garbage in both), lse of
    the fully padded rows equal to the plain version's (−0.7·f32max, which
    the backward reads as P = 1), and the launch on the variant `_variant`
    picks. Returns (max abs error of out, of lse)."""
    scale = 1.0 / q.shape[-1]**0.5
    tc0 = flash_fwd.tc_launches
    out, lse = flash_fwd(q, k, v, bias, True, scale)
    n_tc = flash_fwd.tc_launches - tc0
    want_tc = int(_variant(dtype, q.shape[-1], "flash_fwd") == "tc")
    check(n_tc == want_tc, f"flash_fwd {label} {dtype}: tensor-core launches {n_tc}, want {want_tc}")
    ref, ref_lse = _plain_attention(q, k, v, bias, True, scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().amax(dim=(1, 3))[rows].max().item()
    over = excess(out, ref, dtype).amax(dim=(1, 3))[rows].max().item()
    lse_err = (lse - ref_lse).abs()[rows[:, None, :].expand_as(lse)].max().item()
    check(over <= TOL[dtype][0], f"flash_fwd {label} {dtype}: max abs err {err} over tolerance {TOL[dtype]}")
    check(lse_err <= 1e-3, f"flash_fwd {label} {dtype}: lse err {lse_err}")
    dead = (~rows)[:, None, :].expand_as(lse)
    check(bool(torch.isfinite(lse).all() and torch.equal(lse[dead], ref_lse[dead]) and (lse[dead] == _NEG_BIG).all()),
          f"flash_fwd {label} {dtype}: lse of fully padded rows differs from the plain version's")
    return err, lse_err


def phase_kernel_checks() -> dict:
    """Kernel vs plain on the card; returns {kernel: max abs error}."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    scale = 1.0 / DH**0.5
    errs = {"flash_fwd": 0.0, "decode_attn": 0.0}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dtype in (torch.bfloat16, torch.float32):
        for Tq, S, padded in ((8, 8, False), (10, 128, False), (64, 64, True)):
            q, k, v, bias = _flash_inputs(Tq, S, dtype, padded, gen)
            rows = torch.ones(B, Tq, dtype=torch.bool, device="cuda") if bias is None else bias[:, S - Tq:] == 0
            err, lse_err = _check_fwd(q, k, v, bias, rows, dtype, f"B={B} Tq={Tq} S={S}")
            errs["flash_fwd"] = max(errs["flash_fwd"], err)
            mask = sdpa_mask(bias, Tq, S)
            t_k = cuda_ms(lambda: flash_fwd(q, k, v, bias, True, scale))
            t_p = cuda_ms(lambda: _plain_attention(q, k, v, bias, True, scale))
            t_l = cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=scale))
            log(f"check flash_fwd B={B} H={H} Tq={Tq} S={S} offset={S - Tq} bias={padded} {str(dtype)[6:]}: "
                f"max_abs_err={err:.3e} (atol, rtol {TOL[dtype]}) lse_err={lse_err:.3e} "
                f"kernel_ms={t_k:.4f} plain_ms={t_p:.4f} library_ms={t_l:.4f}")
        for index in (8, 67, 127):
            for padded in (False, True):
                q, k, v, bias = _decode_inputs(index, dtype, padded, gen)
                err = _check_decode(q, k, v, index, bias, dtype, f"index={index} bias={padded}")
                errs["decode_attn"] = max(errs["decode_attn"], err)
                n = index + 1
                kp, vp = k[:, :, :n], v[:, :, :n]
                mask = None if bias is None else (bias[:, :n] == 0)[:, None, None, :]
                t_k = cuda_ms(lambda: decode_attention(q, k, v, index, bias, scale))
                t_p = cuda_ms(lambda: _plain_decode_attention(q, k, v, index, bias, scale))
                t_l = cuda_ms(lambda: sdpa(q, kp, vp, attn_mask=mask, scale=scale))
                log(f"check decode_attn B={B} H={H} T_max={T_MAX} index={index} bias={padded} {str(dtype)[6:]}: "
                    f"max_abs_err={err:.3e} (atol, rtol {TOL[dtype]}) "
                    f"kernel_ms={t_k:.4f} plain_ms={t_p:.4f} library_ms={t_l:.4f}")
    return errs


def _bwd_inputs(Tq, S, dtype, padded, gen, b=TRAIN_B, h=H, dh=DH, live_pad_rows=False):
    """One backward's inputs as the trunk makes them: q/k/v views into a
    fused [b, S, 3, h, dh] projection, the forward's lse, a cotangent zero
    on fully masked (left-pad) query rows, and Δ; the [b, Tq] mask of query
    rows that see a key; and the forward's out. `padded` is False, True or
    "left" (a left-pad bias), or "right" (a right-pad bias: the blocked
    windows of the maze and PPO data). The cotangent is zero on every pad
    query row, as the trunk gives it: no real position reads a left-pad
    row (fully masked) or a right-pad row (causally after every real
    one), and the losses mask both. `live_pad_rows` keeps a random
    cotangent on them instead."""
    qkv = torch.randn(b, S, 3, h, dh, device="cuda", generator=gen).to(dtype)
    q = qkv[:, S - Tq:, 0].transpose(1, 2)
    k, v = qkv[:, :, 1].transpose(1, 2), qkv[:, :, 2].transpose(1, 2)
    bias = torch.zeros(b, S, device="cuda")
    rows = torch.ones(b, Tq, dtype=torch.bool, device="cuda")
    pos = torch.arange(S, device="cuda")[None, :]
    if padded == "right":
        n_valid = torch.randint(1, S + 1, (b,), device="cuda", generator=gen)
        bias = torch.where(pos < n_valid[:, None], 0.0, _NEG_BIG).float()
    elif padded:
        n_pad = torch.randint(0, S, (b,), device="cuda", generator=gen)
        bias = torch.where(pos >= n_pad[:, None], 0.0, _NEG_BIG).float()
        rows = bias[:, S - Tq:] == 0
    out, lse = flash_fwd(q, k, v, bias, True, 1.0 / dh**0.5)
    dout = torch.randn(b, Tq, h, dh, device="cuda", generator=gen).to(dtype).transpose(1, 2)
    if not live_pad_rows:
        dout = dout * (bias[:, S - Tq:] == 0)[:, None, :, None].to(dtype)
    return (q, k, v, bias, lse, _delta(out, dout), dout), rows, out


def _plain_bwd_rounded(q, k, v, bias, lse, delta, dout, causal: bool, scale: float):
    """The plain backward with P and dS rounded to bf16 before the products
    that take them (dV = Pᵀ·dO, dQ = dS·K, dK = dSᵀ·Q), as the tensor-core
    kernels round them as MMA operands; f32 sums → (dq, dk, dv) in bf16."""
    p, ds = _plain_dscores(q, k, v, bias, lse, delta, dout, causal, scale)
    p, ds = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dout.float())
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def _check_bwd_live_pad_rows(gen, errs: dict) -> None:
    """bf16 K2 and K3 on right-padded maze windows whose pad query rows keep
    a live cotangent (no trunk gives them one): up to 160 rows then feed the
    few keys of a short window, and the bf16 rounding of P and dS adds up
    there. At Dh=64 (B=32, H=12) and GPT-J's Dh=256 (B=8, H=16). Held
    against `_plain_bwd_rounded`, the kernels' own arithmetic; the drift
    from the plain version (P and dS in f32) is printed."""
    dtype = torch.bfloat16
    for b, h, dh in ((TRAIN_B, H, DH), (GPTJ_BC_B, GPTJ_H, GPTJ_DH)):
        scale = 1.0 / dh**0.5
        args, _, _ = _bwd_inputs(MAZE_LEN, MAZE_LEN, dtype, "right", gen, b, h, dh, live_pad_rows=True)
        got = (flash_bwd_dq(*args, True, scale), *flash_bwd_dkv(*args, True, scale))
        rounded = _plain_bwd_rounded(*args, True, scale)
        plain = (_plain_bwd_dq(*args, True, scale), *_plain_bwd_dkv(*args, True, scale))
        torch.cuda.synchronize()
        line = []
        for name, a, r, p in zip(("dq", "dk", "dv"), got, rounded, plain):
            err = (a.float() - r.float()).abs().max().item()
            over = ((a.float() - r.float()).abs() - GRAD_TOL[dtype][1] * r.float().abs()).max().item()
            check(over <= GRAD_TOL[dtype][0], f"flash_bwd {name} Dh={dh} live pad rows: max abs err {err} against "
                                              f"the bf16-rounded plain version, over tolerance {GRAD_TOL[dtype]}")
            kernel = "flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"
            errs[kernel] = max(errs[kernel], err)
            line.append(f"{name}_max_abs_err={err:.3e} "
                        f"{name}_drift_from_plain={(a.float() - p.float()).abs().max().item():.3e}")
        log(f"check flash_bwd B={b} H={h} Dh={dh} Tq=S={MAZE_LEN} right-padded, live pad rows, bf16, against the "
            f"bf16-rounded plain version: " + " ".join(line) + f" (atol, rtol {GRAD_TOL[dtype]})")


def _tc_counts():
    return flash_bwd_dq.tc_launches, flash_bwd_dkv.tc_launches


# phase 2's backward cases: (b, h, dh, Tq, S, padding); the training
# shapes first, then the online train step's (B=64, T=128) and the gate's
# (d256 H4: B=512, H=4, T=128), a ragged T (not a multiple of the 64-row
# tile), LLaMA's head width, and the right-padded maze windows blocked to
# 160 tokens of the PPO steps and the PPO forward (B=32, H=12) and of the
# maze gate's train steps (d256 H4: B=32, H=4), and the Text-Nav windows
# blocked to 640 tokens of phase 3n's PPO steps and forwards (B=32, H=12)
# and of the Text-Nav gate's (d256 H4), and GPT-J's head width (B=4,
# H=16, Dh=256, T=160 left-padded); in bf16 also GPT-J's training shapes:
# phase 3jt's ILQL step (B=32, T=160, the trunk's all-zero bias), the
# next-window shape (B=32, T=16), a ragged Tq=37 over S=100 and 3jt's BC
# window (B=8, T=640 left-padded)
BWD_REPS = 5  # phase 2's per-case backward timings
GPTJ_BC_B = 8  # 3jt's BC steps (B=8, T=640); its ILQL step is at TRAIN_B, TRAIN_T
GPTJ_TRAIN_CASE = (TRAIN_B, GPTJ_H, GPTJ_DH, TRAIN_T, TRAIN_T, False)
GPTJ_BC_CASE = (GPTJ_BC_B, GPTJ_H, GPTJ_DH, TN_LEN, TN_LEN, True)
BWD_CASES = (
    (TRAIN_B, H, DH, TRAIN_T, TRAIN_T, False), (TRAIN_B, H, DH, TRAIN_T, TRAIN_T, True),
    (TRAIN_B, H, DH, 96, TRAIN_T, False), (64, H, DH, T_MAX, T_MAX, False), (512, 4, DH, T_MAX, T_MAX, False),
    (TRAIN_B, H, DH, 100, 100, True), (TRAIN_B, H, DH, 37, 100, False), (4, 32, 128, 160, 160, True),
    (TRAIN_B, H, DH, MAZE_LEN, MAZE_LEN, "right"), (TRAIN_B, 4, DH, MAZE_LEN, MAZE_LEN, "right"),
    (TRAIN_B, H, DH, TN_LEN, TN_LEN, "right"), (TRAIN_B, 4, DH, TN_LEN, TN_LEN, "right"),
    (4, GPTJ_H, GPTJ_DH, TRAIN_T, TRAIN_T, True),
)
# GPT-J's bf16 training shapes (3jt; f32 at Dh=256 is the B=4 case's above)
GPTJ_BWD_CASES = (GPTJ_TRAIN_CASE, (TRAIN_B, GPTJ_H, GPTJ_DH, NEXT_T, NEXT_T, True),
                  (4, GPTJ_H, GPTJ_DH, 37, 100, False), GPTJ_BC_CASE)


def phase_bwd_checks() -> tuple:
    """K1, K2 and K3 against their plain versions on the card (`BWD_CASES`:
    the training shapes B=32, H=12, Dh=64 with T=160 and the trunk's
    all-zero bias, T=160 left-padded, and Tq=96 queries right-aligned over
    S=160 keys; a ragged T=100 and Tq=37 over S=100; Dh=128 at B=4, H=32,
    T=160; GPT-J's Dh=256 at H=16: B=4 T=160 left-padded, and in bf16
    `GPTJ_BWD_CASES`, 3jt's ILQL step and BC window, the next-window T=16
    and a ragged Tq=37 over S=100), bf16 through the backward's
    tensor-core variant and f32 through its CUDA-core variant; and K1 alone at the next-window forward's T=16, with
    and without padding. K1 is checked on the inputs the backward kernels
    then take. At Dh=256 in bf16 the CUDA-core variant that the tensor-core
    one replaced is timed beside it (`forced_variant`). Returns the max
    errors, and the bf16 rows of 3jt's two shapes ("gptj_train",
    "gptj_bc": per-kernel ms, bound, plain, SDPA-backward and CUDA-core ms)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    errs = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    gptj_rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        for T, padded in ((NEXT_T, False), (NEXT_T, True)):
            (q, k, v, bias, *_), rows, _ = _bwd_inputs(T, T, dtype, padded, gen)
            err, lse_err = _check_fwd(q, k, v, bias, rows, dtype, f"B={TRAIN_B} Tq=S={T} left_pad={padded}")
            errs["flash_fwd"] = max(errs["flash_fwd"], err)
            log(f"check flash_fwd B={TRAIN_B} H={H} Tq={T} S={T} left_pad={padded} {str(dtype)[6:]}: "
                f"max_abs_err={err:.3e} (atol, rtol {TOL[dtype]}) lse_err={lse_err:.3e}")
        for case in BWD_CASES + (GPTJ_BWD_CASES if dtype == torch.bfloat16 else ()):
            b, h, dh, Tq, S, padded = case
            scale = 1.0 / dh**0.5
            args, rows, _ = _bwd_inputs(Tq, S, dtype, padded, gen, b, h, dh)
            q, k, v, bias, lse, delta, dout = args
            shape = f"B={b} H={h} Dh={dh} Tq={Tq} S={S}"
            fwd_err, lse_err = _check_fwd(q, k, v, bias, rows, dtype, f"{shape} padding={padded}")
            errs["flash_fwd"] = max(errs["flash_fwd"], fwd_err)
            tc0 = _tc_counts()
            dq = flash_bwd_dq(*args, True, scale)
            dk, dv = flash_bwd_dkv(*args, True, scale)
            n_tc = tuple(n - n0 for n, n0 in zip(_tc_counts(), tc0))
            want_tc = tuple(int(_variant(dtype, dh, name) == "tc") for name in ("flash_bwd_dq", "flash_bwd_dkv"))
            check(n_tc == want_tc, f"flash_bwd {shape} {dtype}: tensor-core launches {n_tc}, want {want_tc}")
            ref_dq = _plain_bwd_dq(*args, True, scale)
            ref_dk, ref_dv = _plain_bwd_dkv(*args, True, scale)
            torch.cuda.synchronize()
            line = [f"variant={'tc' if n_tc[0] else 'simt'} flash_fwd_max_abs_err={fwd_err:.3e} lse_err={lse_err:.3e}"]
            for name, pairs in (("flash_bwd_dq", ((dq, ref_dq),)), ("flash_bwd_dkv", ((dk, ref_dk), (dv, ref_dv)))):
                err = max((a.float() - r.float()).abs().max().item() for a, r in pairs)
                over = max(((a.float() - r.float()).abs() - GRAD_TOL[dtype][1] * r.float().abs()).max().item()
                           for a, r in pairs)
                check(over <= GRAD_TOL[dtype][0], f"{name} {shape} bias={padded} {dtype}: max abs err {err} "
                                                  f"over tolerance {GRAD_TOL[dtype]}")
                errs[name] = max(errs[name], err)
                line.append(f"{name}_max_abs_err={err:.3e}")
            # per-case times for the log (the kernels line takes phase_train_shapes'),
            # over BWD_REPS calls; the library's backward (two profiler sessions)
            # in bf16 only, the dtype the paths train in
            row = dict(dq_ms=cuda_ms(lambda: flash_bwd_dq(*args, True, scale), BWD_REPS, 1),
                       dkv_ms=cuda_ms(lambda: flash_bwd_dkv(*args, True, scale), BWD_REPS, 1),
                       plain_dq_ms=cuda_ms(lambda: _plain_bwd_dq(*args, True, scale), BWD_REPS, 1),
                       plain_dkv_ms=cuda_ms(lambda: _plain_bwd_dkv(*args, True, scale), BWD_REPS, 1))
            if dtype == torch.bfloat16:
                row["library_bwd_ms"] = sdpa_bwd_ms(q, k, v, bias, dout, scale, causal_only=not padded and Tq == S,
                                                    reps=BWD_REPS)
                if dh == GPTJ_DH:  # the CUDA-core route that bf16 took here before the tensor-core kernels
                    with forced_variant("simt"):
                        row["simt_dq_ms"] = cuda_ms(lambda: flash_bwd_dq(*args, True, scale), BWD_REPS, 1)
                        row["simt_dkv_ms"] = cuda_ms(lambda: flash_bwd_dkv(*args, True, scale), BWD_REPS, 1)
            for kind in ("dq", "dkv"):
                row[f"bound_{kind}_ms"], row[f"bound_{kind}_by"] = bound_ms(
                    *bwd_work(b, h, dh, Tq, S, dtype, kind, bias is not None), dtype)
            log(f"check flash_bwd {shape} offset={S - Tq} padding={padded} {str(dtype)[6:]}: "
                + " ".join(line) + f" (atol, rtol fwd {TOL[dtype]}, bwd {GRAD_TOL[dtype]}) "
                + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()))
            if dtype == torch.bfloat16 and case in (GPTJ_TRAIN_CASE, GPTJ_BC_CASE):
                gptj_rows["gptj_train" if case == GPTJ_TRAIN_CASE else "gptj_bc"] = row
    _check_bwd_live_pad_rows(gen, errs)
    return errs, gptj_rows


def phase_path_checks() -> tuple:
    """K1 and K4 against their plain versions at the shapes the later paths
    give them, bf16 (their dtype, so the tensor-core K1): the online
    rollout (B=256, H=12) and the gate's evals (B=512, H=4) — K1 at
    Tq=8 over S=8 and Tq=10 over S=68 and 128 of a T_MAX cache, K4 at
    index 8, 67 and 127; the text env's legal-set serving (B=8, prompts
    left-padded to T_MAX, a cache of T_MAX + 10) and LMServer's (B=4,
    prompts padded to 48, a cache of 58) — K1 on the left-padded prefill
    with bias, K4 with bias at the first, a middle and the last of the 10
    decode slots; the PPO rollout's LMServer (B=16, H=12) and the maze
    gate's evals (B=25, H=4), prompts left-padded to 160 with 12 new
    tokens, in bf16 and f32; the Text-Nav rollouts' (B=16, H=12 and 4),
    prompts left-padded to 640 with 36 new tokens, bf16; and K1 on the score calls' 100 proposals
    right-padded to 160 (H=12 and 4), bf16 and f32. The online, gate, PPO
    and maze gate train steps' K1-K3 shapes are in BWD_CASES. Returns
    ({kernel: max abs error}, the f32 dialog shapes' timings)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    dtype = torch.bfloat16
    errs = {"flash_fwd": 0.0, "decode_attn": 0.0}
    for b, h in ((256, H), (512, 4)):
        for Tq, S in ((8, 8), (10, 68), (10, T_MAX)):
            q, k, v, bias = _flash_inputs(Tq, S, dtype, False, gen, b, h, t_max=T_MAX)
            rows = torch.ones(b, Tq, dtype=torch.bool, device="cuda")
            err, lse_err = _check_fwd(q, k, v, bias, rows, dtype, f"B={b} H={h} Tq={Tq} S={S}")
            errs["flash_fwd"] = max(errs["flash_fwd"], err)
            log(f"check flash_fwd B={b} H={h} Tq={Tq} S={S} (cache view) bf16: max_abs_err={err:.3e} "
                f"(atol, rtol {TOL[dtype]}) lse_err={lse_err:.3e}")
        for index in (8, 67, 127):
            q, k, v, bias = _decode_inputs(index, dtype, False, gen, b, h)
            err = _check_decode(q, k, v, index, bias, dtype, f"B={b} H={h} index={index}")
            errs["decode_attn"] = max(errs["decode_attn"], err)
            log(f"check decode_attn B={b} H={h} T_max={T_MAX} index={index} bf16: max_abs_err={err:.3e}")
    # (batch, heads, prompt, new tokens, dtype): the text env, LMServer, the
    # PPO rollout's LMServer (B=16) and the maze gate's evals (d256 H4, 25
    # cells); the maze paths in f32 too (their CUDA-core K1)
    maze = [(16, H, MAZE_LEN, MAZE_NEW, dt) for dt in (dtype, torch.float32)]
    maze += [(25, 4, MAZE_LEN, MAZE_NEW, dt) for dt in (dtype, torch.float32)]
    # the Text-Nav rollouts' LMServer at GPT-2-small (3n) and d256 H4 (3w)
    maze += [(16, H, TN_LEN, TN_NEW, dtype), (16, 4, TN_LEN, TN_NEW, dtype)]
    for b, h, prompt, n_new, dtype in [(8, H, T_MAX, 10, dtype), (4, H, 48, 10, dtype)] + maze:
        t_max = prompt + n_new
        q, k, v, bias = _flash_inputs(prompt, prompt, dtype, True, gen, b, h, t_max=t_max)
        err, lse_err = _check_fwd(q, k, v, bias, bias == 0, dtype, f"B={b} H={h} prefill {prompt} left-padded")
        errs["flash_fwd"] = max(errs["flash_fwd"], err)
        log(f"check flash_fwd B={b} H={h} prefill Tq=S={prompt} of a {t_max} cache, left-padded {str(dtype)[6:]}: "
            f"max_abs_err={err:.3e} (atol, rtol {TOL[dtype]}) lse_err={lse_err:.3e}")
        for index in (prompt, prompt + n_new // 2, prompt + n_new - 1):
            q, k, v, bias = _decode_inputs(index, dtype, True, gen, b, h, t_max=t_max, max_pad=prompt - 1)
            err = _check_decode(q, k, v, index, bias, dtype, f"B={b} H={h} T_max={t_max} index={index} left-padded")
            errs["decode_attn"] = max(errs["decode_attn"], err)
            log(f"check decode_attn B={b} H={h} T_max={t_max} index={index} left-padded {str(dtype)[6:]}: "
                f"max_abs_err={err:.3e}")
    # the score calls: 25 cells x 4 move proposals, right-padded to 160
    for h in (H, 4):
        for dtype in (torch.bfloat16, torch.float32):
            (q, k, v, bias, *_), rows, _ = _bwd_inputs(MAZE_LEN, MAZE_LEN, dtype, "right", gen, 100, h)
            err, lse_err = _check_fwd(q, k, v, bias, rows, dtype, f"B=100 H={h} T={MAZE_LEN} right-padded")
            errs["flash_fwd"] = max(errs["flash_fwd"], err)
            log(f"check flash_fwd B=100 H={h} Tq=S={MAZE_LEN} right-padded (score call) {str(dtype)[6:]}: "
                f"max_abs_err={err:.3e} (atol, rtol {TOL[dtype]}) lse_err={lse_err:.3e}")
    _check_markov_shapes(gen, errs)
    return errs, _check_dialog_shapes(gen, errs)


# the Markov paths' shapes (batch, heads, obs, act): the 3k rollouts (maze,
# chess FEN), the online guided chess rollouts (B=256), the chess gate's
# evals (d256 H4, grid: 72 + 8)
MARKOV_ROLLOUT_SHAPES = ((512, H, 20, 11), (512, H, 96, 8), (256, H, 96, 8), (256, 4, 72, 8))
# their train steps (batch, heads, T): online Markov ILQL windows (chess FEN
# 104, the maze's 31), the chess gate's BC (B=64) and ILQL (B=512) windows
MARKOV_TRAIN_SHAPES = ((64, H, 104), (64, H, 31), (64, 4, 80), (512, 4, 80))
# the chess gate's reranker score calls at the full budget (batch, heads, T):
# a full chunk of 4,096 candidate windows and the held-out pool's last chunk
MARKOV_SCORE_SHAPES = ((4096, 4, 80), (2776, 4, 80))


def _check_markov_shapes(gen, errs: dict) -> None:
    """bf16, the Markov paths' dtype: K1 on each turn's observation prefill
    (Tq = S = obs, a cache view of the obs + act window) and K4 at every
    action slot of the window; K1, K2 and K3 on the train windows, and K1
    alone on the next-window forward (T = obs) and the gate's score calls."""
    dtype = torch.bfloat16
    for b, h, obs, act in MARKOV_ROLLOUT_SHAPES:
        W = obs + act
        q, k, v, bias = _flash_inputs(obs, obs, dtype, False, gen, b, h, t_max=W)
        err, lse_err = _check_fwd(q, k, v, bias, torch.ones(b, obs, dtype=torch.bool, device="cuda"), dtype,
                                  f"B={b} H={h} prefill {obs} of {W}")
        errs["flash_fwd"] = max(errs["flash_fwd"], err)
        dec_err = 0.0
        for index in range(obs, W):
            q, k, v, bias = _decode_inputs(index, dtype, False, gen, b, h, t_max=W)
            dec_err = max(dec_err, _check_decode(q, k, v, index, bias, dtype, f"B={b} H={h} T_max={W} index={index}"))
        errs["decode_attn"] = max(errs["decode_attn"], dec_err)
        log(f"check markov B={b} H={h} obs={obs} act={act} bf16: flash_fwd prefill (cache view of {W}) "
            f"max_abs_err={err:.3e} lse_err={lse_err:.3e}; decode_attn index {obs}..{W - 1} max_abs_err={dec_err:.3e}")
    scale = 1.0 / DH**0.5
    for b, h, T in MARKOV_TRAIN_SHAPES:
        for Tq in (T, T - 8) if T != 31 else (T, 20):  # the window, then the next window's forward alone
            args, rows, _ = _bwd_inputs(Tq, Tq, dtype, False, gen, b, h)
            fwd_err, _ = _check_fwd(*args[:4], rows, dtype, f"B={b} H={h} T={Tq}")
            errs["flash_fwd"] = max(errs["flash_fwd"], fwd_err)
            if Tq != T:
                continue
            got = (flash_bwd_dq(*args, True, scale), *flash_bwd_dkv(*args, True, scale))
            ref = (_plain_bwd_dq(*args, True, scale), *_plain_bwd_dkv(*args, True, scale))
            torch.cuda.synchronize()
            line = [f"flash_fwd_max_abs_err={fwd_err:.3e}"]
            for name, a, r in zip(("dq", "dk", "dv"), got, ref):
                err = (a.float() - r.float()).abs().max().item()
                over = ((a.float() - r.float()).abs() - GRAD_TOL[dtype][1] * r.float().abs()).max().item()
                check(over <= GRAD_TOL[dtype][0], f"flash_bwd {name} B={b} H={h} T={T}: max abs err {err} over "
                                                  f"tolerance {GRAD_TOL[dtype]}")
                kernel = "flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"
                errs[kernel] = max(errs.get(kernel, 0.0), err)
                line.append(f"{name}_max_abs_err={err:.3e}")
            log(f"check markov train B={b} H={h} T={T} bf16: " + " ".join(line) + f" (atol, rtol {GRAD_TOL[dtype]})")
    for b, h, T in MARKOV_SCORE_SHAPES:
        args, rows, _ = _bwd_inputs(T, T, dtype, False, gen, b, h)
        err, lse_err = _check_fwd(*args[:4], rows, dtype, f"score call B={b} H={h} T={T}")
        errs["flash_fwd"] = max(errs["flash_fwd"], err)
        log(f"check markov score call B={b} H={h} T={T} bf16: flash_fwd max_abs_err={err:.3e} lse_err={lse_err:.3e}")


def phase_train_shapes() -> dict:
    """Per-launch times at the shapes one ILQL train step launches, bf16
    with the trunk's all-zero bias: K2 and K3 at T=160 (12 each per step,
    the tensor-core variant; the library yardstick is SDPA's backward, one
    device time for the pair, which computes its own rowsum(dO ⊙ O), so
    the port's Δ pass and the pair plus Δ stand beside it); K1 at
    T=160 (24 per step: trained and target trunk) and T=16 (12: the
    next-window forward), logged per shape and returned as the mean over
    the step's 36 launches under "flash_fwd_train_step"."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    scale = 1.0 / DH**0.5
    dtype = torch.bfloat16
    args, _, fwd_out = _bwd_inputs(TRAIN_T, TRAIN_T, dtype, False, gen)
    q, k, v, bias, lse, delta, dout = args
    lib = sdpa_bwd_ms(q, k, v, bias, dout, scale, causal_only=True)
    t_delta = cuda_ms(lambda: _delta(fwd_out, dout))
    out = {}
    for name, fn, plain, kind in (("flash_bwd_dq", flash_bwd_dq, _plain_bwd_dq, "dq"),
                                  ("flash_bwd_dkv", flash_bwd_dkv, _plain_bwd_dkv, "dkv")):
        t_b, by = bound_ms(*bwd_work(TRAIN_B, H, DH, TRAIN_T, TRAIN_T, dtype, kind, True), dtype)
        out[name] = dict(ms=cuda_ms(lambda: fn(*args, True, scale)), plain_ms=cuda_ms(lambda: plain(*args, True, scale)),
                         library_ms=lib, bound_ms=t_b, bound_by=by, delta_ms=t_delta)
    pair = out["flash_bwd_dq"]["ms"] + out["flash_bwd_dkv"]["ms"] + t_delta
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        out[name]["pair_plus_delta_ms"] = pair
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, simt_ms=0.0, n_bytes=0.0, flops=0.0)
    for T, per_step in ((TRAIN_T, 2), (NEXT_T, 1)):  # launches per layer and step at this shape
        (fq, fk, fv, fbias, *_), _, _ = _bwd_inputs(T, T, dtype, False, gen)
        row = dict(ms=cuda_ms(lambda: flash_fwd(fq, fk, fv, fbias, True, scale)),
                   plain_ms=cuda_ms(lambda: _plain_attention(fq, fk, fv, fbias, True, scale)),
                   library_ms=device_ms(lambda: sdpa(fq, fk, fv, is_causal=True, scale=scale)))
        with forced_variant("simt"):
            row["simt_ms"] = cuda_ms(lambda: flash_fwd(fq, fk, fv, fbias, True, scale))
        n_bytes, flops = flash_work(TRAIN_B, H, DH, T, T, dtype)
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, flops, dtype)
        log(f"train-step shapes flash_fwd B={TRAIN_B} T={T} (bf16, per launch): "
            + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()))
        for key in ("ms", "plain_ms", "library_ms", "simt_ms"):
            fwd[key] += per_step * row[key] / 3
        fwd["n_bytes"] += per_step * n_bytes / 3
        fwd["flops"] += per_step * flops / 3
    fwd["bound_ms"], fwd["bound_by"] = bound_ms(fwd.pop("n_bytes"), fwd.pop("flops"), dtype)
    out["flash_fwd_train_step"] = fwd
    log("train-step shapes flash_fwd (bf16, mean over a step's launches): "
        + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in fwd.items()))
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        row = out[name]
        log(f"train-step shapes {name} B={TRAIN_B} T={TRAIN_T} (bf16, per launch; library = SDPA backward of the pair): "
            + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()))
    return out


def phase_main_path_shapes() -> dict:
    """Mean per-launch times over the shapes one trunk's rollout launches:
    flash_fwd at (Tq=8, S=8) and (Tq=10, S=28..128 step 20); decode_attn at
    the 60 fills of the action slots. bf16, no padding bias (the actor's
    stream has none)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    scale = 1.0 / DH**0.5
    dtype = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flash_shapes = [(8, 8)] + [(10, 28 + 20 * t) for t in range(N_TRIES)]
    decode_index = [8 + 20 * t + s for t in range(N_TRIES) for s in range(10)]
    out = {}

    sums = [0.0, 0.0, 0.0, 0.0, 0.0]
    k_all = torch.randn(B, H, T_MAX, DH, device="cuda", generator=gen).to(dtype)
    v_all = torch.randn(B, H, T_MAX, DH, device="cuda", generator=gen).to(dtype)
    for Tq, S in flash_shapes:
        q = torch.randn(B, H, Tq, DH, device="cuda", generator=gen).to(dtype)
        k, v = k_all[:, :, :S], v_all[:, :, :S]  # the filled cache prefix, a strided view
        mask = sdpa_mask(None, Tq, S)
        sums[0] += cuda_ms(lambda: flash_fwd(q, k, v, None, True, scale))
        sums[1] += cuda_ms(lambda: _plain_attention(q, k, v, None, True, scale))
        sums[2] += cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=scale))
        sums[3] += bound_ms(*flash_work(B, H, DH, Tq, S, dtype), dtype)[0]
        with forced_variant("simt"):
            sums[4] += cuda_ms(lambda: flash_fwd(q, k, v, None, True, scale))
    n = len(flash_shapes)
    out["flash_fwd"] = dict(
        ms=sums[0] / n, plain_ms=sums[1] / n, library_ms=sums[2] / n, bound_ms=sums[3] / n,
        bound_by=bound_ms(*flash_work(B, H, DH, 10, 128, dtype), dtype)[1], simt_ms=sums[4] / n,
    )

    sums = [0.0, 0.0, 0.0, 0.0]
    q = torch.randn(B, H, 1, DH, device="cuda", generator=gen).to(dtype)
    for index in decode_index:
        kp, vp = k_all[:, :, :index + 1], v_all[:, :, :index + 1]
        sums[0] += cuda_ms(lambda: decode_attention(q, k_all, v_all, index, None, scale), reps=10)
        sums[1] += cuda_ms(lambda: _plain_decode_attention(q, k_all, v_all, index, None, scale), reps=10)
        sums[2] += cuda_ms(lambda: sdpa(q, kp, vp, scale=scale), reps=10)
        sums[3] += bound_ms(*decode_work(B, H, DH, index + 1, dtype), dtype)[0]
    n = len(decode_index)
    out["decode_attn"] = dict(
        ms=sums[0] / n, plain_ms=sums[1] / n, library_ms=sums[2] / n, bound_ms=sums[3] / n,
        bound_by=bound_ms(*decode_work(B, H, DH, 68, dtype), dtype)[1],
    )
    for name, row in out.items():
        log(f"main-path shapes {name} (bf16, mean per launch): " + " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()))
    return out


def _check_no_einsum(where: str) -> None:
    """No path of the kernels' configs reaches the model's einsum route
    (`attention_einsum`, the route for head dims and dtypes the kernels
    refuse): its counter is never reset before phase 3a, so 0 here means
    0 on every path so far."""
    check(attention_einsum.calls == 0, f"{where}: {attention_einsum.calls} attention calls took the einsum route")


def _reset_counts():
    _check_no_einsum("launch counts")
    flash_fwd.launches = flash_fwd.tc_launches = 0
    decode_attention.launches = decode_attention.split_launches = 0
    flash_bwd_dq.launches = flash_bwd_dq.tc_launches = 0
    flash_bwd_dkv.launches = flash_bwd_dkv.tc_launches = 0


def _counts():
    return flash_fwd.launches, decode_attention.launches


def _train_counts():
    return flash_fwd.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches


COUNT_NAMES = ("flash_fwd", "flash_fwd_tc", "decode_attn", "flash_bwd_dq", "flash_bwd_dq_tc", "flash_bwd_dkv",
               "flash_bwd_dkv_tc")


class _Counts(tuple):
    """Launch counts in COUNT_NAMES' order, equal to the plain tuple of
    them; `split` is K4's launches on its split route, a route taken inside
    those launches and not a launch count of its own, so the exact-launch
    gates do not read it."""
    split = 0


def _all_counts() -> tuple:
    """Every launch counter, in COUNT_NAMES' order (K1 and its tensor-core
    share, K4, K2 and its share, K3 and its share), with K4's split-route
    share as `split`."""
    counts = _Counts((flash_fwd.launches, flash_fwd.tc_launches, decode_attention.launches, flash_bwd_dq.launches,
                      flash_bwd_dq.tc_launches, flash_bwd_dkv.launches, flash_bwd_dkv.tc_launches))
    counts.split = decode_attention.split_launches
    return counts


def _fmt_counts(counts: tuple) -> str:
    return " ".join(f"{n}={c}" for n, c in zip(COUNT_NAMES, counts))


def _check_rollout(out, env, batch: int = B, constrained: bool = True) -> None:
    """The rollout's invariants; a `constrained` decode also forces the
    action separators and makes every live guess a vocab word."""
    live = out.turn_live
    check(out.tokens.shape == (batch, actor.EPISODE_LEN), f"tokens shape {tuple(out.tokens.shape)}")
    check(bool((live[:, :-1] >= live[:, 1:]).all()), "turn liveness is not monotone")
    check(bool(live[:, 0].all()), "a game was done before its first turn")
    tr = out.turn_reward
    check(bool(torch.isfinite(tr).all() and ((tr >= -1) & (tr <= 0)).all()), "turn rewards outside [-1, 0]")
    check(bool((out.n_turns == live.sum(-1)).all()), "n_turns disagrees with turn_live")
    toks = out.tokens.cpu()
    header = torch.tensor(actor.HEADER)
    check(bool((toks[:, : len(actor.HEADER)] == header).all()), "header tokens")
    words = set(env.vocab.words)
    for t in range(N_TRIES):
        off = len(actor.HEADER) + t * actor.TURN_LEN
        act, obs = toks[:, off: off + 10], toks[:, off + 10: off + 20]
        check(bool((obs[:, 1:9:2] == 32).all() and (obs[:, 9] == 10).all()), f"turn {t}: observation separators")
        check(bool(torch.isin(obs[:, 0:10:2], torch.tensor([98, 121, 103])).all()), f"turn {t}: feedback letters")
        if not constrained:
            continue
        check(bool((act[:, 1:9:2] == 32).all() and (act[:, 9] == 10).all()), f"turn {t}: action separators")
        for b in torch.nonzero(live[:, t].cpu()).flatten().tolist():
            word = bytes(act[b, 0:10:2].tolist()).decode()
            check(word in words, f"turn {t} row {b}: constrained guess {word!r} is not a vocab word")


def profile_run(label: str, run, unprofiled_s: float) -> None:
    """One more run (a rollout, a train step) under torch.profiler: device
    busy time (one stream, so the sum of kernel times) against the wall
    clock of this run and of the unprofiled one, the device time by kernel
    category and the top kernels. Device activity only: recording every
    host op as well made the trace's processing several times slower (a
    B=256 two-trunk Markov rollout, ~48,000 launches: 34 s against 13 s on
    the H100) and changes no device number."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = device_kernel_times(prof)
        busy_ms = sum(ms for ms, _ in kernels.values())
        if busy_ms > 0:
            break
    else:
        log(f"profile {label}: the profiler recorded no device time in {PROFILER_TRIES} tries; no breakdown")
        return
    log(f"profile {label}: wall_ms={wall_ms:.1f} device_busy_ms={busy_ms:.1f} idle_share={1 - busy_ms / wall_ms:.3f} "
        f"(against the unprofiled {label}: {1 - busy_ms / (unprofiled_s * 1e3):.3f}); "
        f"{sum(n for _, n in kernels.values())} kernels, trace read in {time.perf_counter() - t0 - wall_ms / 1e3:.1f} s")
    by_cat: dict = {}
    for name, (ms, n) in kernels.items():
        cat = _kernel_category(name)
        cat_ms, cat_n = by_cat.get(cat, (0.0, 0))
        by_cat[cat] = (cat_ms + ms, cat_n + n)
    for cat, (ms, n) in sorted(by_cat.items(), key=lambda kv: -kv[1][0]):
        log(f"  device {cat}: {ms:.1f} ms ({ms / wall_ms:.3f} of wall) in {n} launches")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"  kernel {ms:8.1f} ms x{n:5d}  {name[:110]}")


def phase_slice() -> dict:
    config = gpt2_small().replace(pad_vocab_to_multiple=128, embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)
    check(config.vocab_size == 50257 and config.padded_vocab_size == 50304, "gpt2_small vocab")
    core = LMCore(config)
    t0 = time.perf_counter()
    pi_beta = init_params(config, seed=0, dtype=torch.bfloat16)
    base = init_params(config, seed=1, dtype=torch.bfloat16)
    head_cfg = MLPHeadConfig(input_dim=config.hidden_size, hidden_dim=2 * config.hidden_size,
                             output_dim=config.padded_vocab_size)
    q1, q2 = MLPHead(head_cfg, seed=2), MLPHead(head_cfg, seed=3)
    env = WordleVectorEnv(WordleVocab.from_file())
    params = {"pi_beta": pi_beta, "base": base, "q1": q1, "q2": q2}
    step_fn, carry0 = actor.make_value_guided_step_fn(core, B, two_trunks=True, twin_q=True, beta=32.0)
    torch.cuda.synchronize()
    log(f"slice setup (gpt2-small x2 bf16, twin MLP Q heads f32, B={B}): {time.perf_counter() - t0:.2f} s")

    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    actor.rollout_wordle(env, step_fn, params, carry0, B, constrain_vocab=True, generator=gen)
    torch.cuda.synchronize()
    log(f"warm-up rollout: {time.perf_counter() - t0:.3f} s")

    torch.cuda.reset_peak_memory_stats()
    times = []
    for rep in range(ROLLOUT_REPS):
        _reset_counts()
        t0 = time.perf_counter()
        out = actor.rollout_wordle(env, step_fn, params, carry0, B, constrain_vocab=True, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        n_flash, n_decode = _counts()
        check(n_flash == 7 * config.num_layers * 2, f"flash_fwd launched {n_flash} times, want 168")
        check(n_decode == 60 * config.num_layers * 2, f"decode_attn launched {n_decode} times, want 1440")
        check(flash_fwd.tc_launches == n_flash, f"flash_fwd: {flash_fwd.tc_launches} of {n_flash} launches on the tensor cores")
        # B x H = 6,144 blocks: the one-block route, the bits of the parent
        check(decode_attention.split_launches == 0, f"decode_attn: {decode_attention.split_launches} split-route launches")
        _check_rollout(out, env)
        rollout_tc = flash_fwd.tc_launches
        ret = (out.turn_reward * out.turn_live).sum(1).mean().item()
        log(f"rollout {rep} B={B}: {times[-1]:.4f} s, launches flash_fwd={n_flash} (tensor cores "
            f"{flash_fwd.tc_launches}) decode_attn={n_decode}, "
            f"return={ret:.3f} win={out.win.float().mean().item():.3f} turns={out.n_turns.float().mean().item():.2f}")
    dt = sorted(times)[len(times) // 2]
    log(f"rollout median of {ROLLOUT_REPS}: {dt:.4f} s (min {min(times):.4f}, max {max(times):.4f}), "
        f"env_steps_per_s={B * N_TRIES / dt:.1f} tokens_per_s={B * actor.EPISODE_LEN / dt:.1f} "
        f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    profile_run(
        "rollout", lambda: actor.rollout_wordle(env, step_fn, params, carry0, B, constrain_vocab=True, generator=gen), dt
    )

    server = ValueGuidedServer(core, ByteTokenizer(), beta=32.0, share_trunk=False)
    prompts = [
        "Wordle:\n",
        "Wordle:\nc r a n e\nb b y b g\n",
        "Wordle:\nc r a n e\nb b y b g\nm o i s t\nb y b b b\n",
        "Wordle:\ns l a t e\ng b b b y\n",
    ]
    sampling = SamplingConfig(max_new_tokens=10, greedy=True, eos_token_id=10, pad_token_id=256)
    _reset_counts()
    t0 = time.perf_counter()
    answers = server.generate_from_strs(ValueRLParams(pi_beta, base, q1, q2, None), prompts, 48, sampling)
    torch.cuda.synchronize()
    n_flash, n_decode = _counts()
    log(f"server: {len(answers)} answers in {time.perf_counter() - t0:.3f} s, launches flash_fwd={n_flash} "
        f"decode_attn={n_decode}")
    check(len(answers) == len(prompts) and all(isinstance(a, str) for a in answers), "server answers")
    check(n_flash == config.num_layers * 2 and n_decode == 10 * config.num_layers * 2, "server launch counts")
    check(flash_fwd.tc_launches == n_flash, f"server: {flash_fwd.tc_launches} of {n_flash} flash_fwd launches on the tensor cores")
    log("  (random weights over the 50,257-token vocab: ids >= 256 have no byte and decode to nothing)")
    for p, a in zip(prompts, answers):
        log(f"  prompt {p!r} -> {a!r}")
    return {"flash_fwd": 7 * config.num_layers * 2, "flash_fwd_tc": rollout_tc, "decode_attn": 60 * config.num_layers * 2,
            "decode_attn_split": 0, "base": base, "config": config, "serving": ValueRLParams(pi_beta, base, q1, q2, None)}


@contextlib.contextmanager
def traced_online_round(record: list, rollout_name: str = "rollout_wordle"):
    """Wraps the calls an online loop makes each round — the rollout
    (`actor.<rollout_name>`) and every train step — so each records its
    launch counts (set to 0 just before the call, read just after it) and
    its wall time; the rollout also keeps its output and a copy of the
    trunk's final norm weights at the round's start."""
    rollout_fn, make_step = getattr(actor, rollout_name), online_device.make_ilql_train_step

    def rollout(env, *args, **kwargs):
        params = next(a for a in args if isinstance(a, dict))
        weights = params["base"].ln_f.weight.detach().clone()
        _reset_counts()
        t0 = time.perf_counter()
        res = rollout_fn(env, *args, **kwargs)
        _sync(env.device)
        out = res if isinstance(res, actor.WordleRollout) else res[0]  # rollout_markov: (rollout, state)
        record.append(dict(kind="rollout", s=time.perf_counter() - t0, counts=_all_counts(), out=out, weights=weights))
        return res

    def make(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def traced(*step_args, **step_kwargs):
            _reset_counts()
            t0 = time.perf_counter()
            res = step(*step_args, **step_kwargs)
            _sync(res[1].device)
            record.append(dict(kind="step", s=time.perf_counter() - t0, counts=_all_counts(), loss=res[1].item()))
            return res

        return traced

    setattr(actor, rollout_name, rollout)
    online_device.make_ilql_train_step = make
    try:
        yield
    finally:
        setattr(actor, rollout_name, rollout_fn)
        online_device.make_ilql_train_step = make_step


def phase_online(config) -> dict:
    """Phase 3o: `online_ilql_wordle` at full width with its default config,
    cut to ONLINE_ROUNDS rounds."""
    L = config.num_layers
    core = LMCore(config)
    t0 = time.perf_counter()
    base, q1, q2, v = _train_modules(config, "cuda")
    ilql_config = ILQLConfig(beta=32.0)
    state = init_ilql_state(base, q1, q2, v, adamw(1e-4), adamw(1e-3), ilql_config)
    ocfg = OnlineDeviceConfig(n_rounds=ONLINE_ROUNDS)
    env = WordleVectorEnv(WordleVocab.from_file())
    gen = torch.Generator(device="cuda").manual_seed(7)
    torch.cuda.synchronize()
    n_steps = ocfg.rollout_batch // ocfg.train_bsize * ocfg.epochs_per_round
    log(f"online setup (gpt2-small f32 params, bf16 activations, twin MLP Q heads + V head, separate target base, "
        f"beta=32, {ocfg}): {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    record: list = []
    t0 = time.perf_counter()
    with traced_online_round(record):
        state, history = online_ilql_wordle(core, state, env, ilql_config, ocfg, generator=gen)
    total = time.perf_counter() - t0
    check(len(record) == ocfg.n_rounds * (1 + n_steps) and len(history) == ocfg.n_rounds,
          f"online: {len(record)} traced calls over {len(history)} rounds")
    want_roll = (7 * L, 7 * L, 60 * L, 0, 0, 0, 0)  # one trunk: 7 multi-token forwards, 60 decode steps
    want_step = (2 * L, 2 * L, 0, L, L, L, L)  # trained and target forwards (no next window), one backward
    roll_s, train_s = [], []
    for r in range(ocfg.n_rounds):
        roll, steps = record[r * (1 + n_steps)], record[r * (1 + n_steps) + 1: (r + 1) * (1 + n_steps)]
        check(roll["kind"] == "rollout" and all(st["kind"] == "step" for st in steps), f"online round {r}: call order")
        check(roll["counts"] == want_roll, f"online round {r} rollout: {_fmt_counts(roll['counts'])}, want {want_roll}")
        _check_rollout(roll["out"], env, ocfg.rollout_batch, constrained=False)
        for i, st in enumerate(steps):
            check(st["counts"] == want_step, f"online round {r} step {i}: {_fmt_counts(st['counts'])}, want {want_step}")
            check(math.isfinite(st["loss"]), f"online round {r} step {i}: loss {st['loss']}")
        if r:
            check(not torch.equal(record[(r - 1) * (1 + n_steps)]["weights"], roll["weights"]),
                  f"online round {r}: the trunk's weights did not move since round {r - 1}")
        roll_s.append(roll["s"])
        train_s.append(sum(st["s"] for st in steps))
        m = history[r]
        check(math.isfinite(m["loss"]), f"online round {r}: loss {m['loss']}")
        log(f"online round {r}: rollout B={ocfg.rollout_batch} {roll['s']:.3f} s ({_fmt_counts(roll['counts'])}), "
            f"train {train_s[-1]:.3f} s for {n_steps} steps B={ocfg.train_bsize} T={actor.EPISODE_LEN} "
            f"(per step {_fmt_counts(steps[0]['counts'])}; losses {[round(st['loss'], 4) for st in steps]}), "
            f"return {m['mean_episode_reward']:.3f} win {m['win_rate']:.3f} turns {m['mean_turns']:.2f}")
    log(f"online ILQL: {ocfg.n_rounds} rounds in {total:.3f} s; per round rollout {sum(roll_s) / len(roll_s):.3f} s, "
        f"train {sum(train_s) / len(train_s):.3f} s; peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")

    # the same two calls once more on the live modules, each under the profiler
    step_fn, carry0 = actor.make_value_guided_step_fn(core, ocfg.rollout_batch, two_trunks=False, twin_q=True,
                                                      beta=ilql_config.beta)
    policy = {"base": state.base.params, "q1": state.q1_head.params, "q2": state.q2_head.params}
    profile_run("online rollout", lambda: actor.rollout_wordle(env, step_fn, policy, carry0, ocfg.rollout_batch,
                                                               generator=gen), sorted(roll_s)[len(roll_s) // 2])
    batch = wordle_rollout_to_ilql_batch(actor.rollout_wordle(env, step_fn, policy, carry0, ocfg.rollout_batch,
                                                              generator=gen))
    step = make_ilql_train_step(core, ilql_config, ocfg.pad_token_id)
    mb = ocfg.train_bsize

    def train_round():
        for i in range(n_steps):
            step(state, ILQLBatch(*(None if x is None else x[i * mb: (i + 1) * mb] for x in batch)))

    profile_run("online train steps (one round)", train_round, sorted(train_s)[len(train_s) // 2])
    # the launches the last round recorded (every round's were checked above)
    last = record[-(1 + n_steps):]
    per_round = tuple(sum(c) for c in zip(*(call["counts"] for call in last)))
    out = {f"{name}_online_round": n for name, n in zip(COUNT_NAMES, per_round)}
    out.update({f"{name}_online_step": n for name, n in zip(COUNT_NAMES, last[-1]["counts"])})
    return out


GATE_STEPS = 15  # 3g: updates per stage (BC, %BC, ILQL), one eval at the end
GATE_ARGS = ["--bc-steps", str(GATE_STEPS), "--pbc-steps", str(GATE_STEPS), "--ilql-steps", str(GATE_STEPS),
             "--eval-every", str(GATE_STEPS), "--eval-batch", "512", "--optimal-episodes", "0"]
GATE_LAYERS = 4  # the gate's default --layers
GATE_LM_EVALS, GATE_GUIDED_EVALS = 4, 3  # BC and %BC, sampled and greedy; ILQL live, target and greedy


def phase_gate() -> dict:
    """Phase 3g: the port's Wordle ILQL gate at its own width and a cut budget."""
    L = GATE_LAYERS
    n_bc, n_ilql = 2 * GATE_STEPS, GATE_STEPS
    fwd = n_bc * L + n_ilql * 2 * L + GATE_LM_EVALS * 7 * L + GATE_GUIDED_EVALS * 2 * 7 * L
    dec = GATE_LM_EVALS * 60 * L + GATE_GUIDED_EVALS * 2 * 60 * L
    bwd = (n_bc + n_ilql) * L
    want = (fwd, fwd, dec, bwd, bwd, bwd, bwd)
    _reset_counts()
    t0 = time.perf_counter()
    result = wordle_ilql_gate.main(GATE_ARGS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _all_counts()
    check(counts == want, f"gate launched {_fmt_counts(counts)}, want {want}")
    returns = {k: v for k, v in result.items() if "return" in k and v is not None}
    returns.update({f"curve_{c['step']}": c["ret"] for c in result["curve"]})
    for k, v in returns.items():
        check(math.isfinite(v) and -6.0 <= v <= 0.0, f"gate {k} = {v}, want a finite return in [-6, 0]")
    log(f"gate ({' '.join(GATE_ARGS)}): {dt:.1f} s, {_fmt_counts(counts)}; "
        + " ".join(f"{k}={v:.3f}" for k, v in result.items() if isinstance(v, float)))
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), GATE_RECORD)) as f:
        record = json.load(f)
    for k in GATE_STATS:
        check(result[k] == record[k], f"gate {k} = {result[k]!r} on the JAX stream, the record's {record[k]!r}")
    log("gate behavior / ceiling stats on the JAX stream equal " + GATE_RECORD + "'s: "
        + ", ".join(f"{k} {result[k]!r}" for k in GATE_STATS))
    out = {f"{name}_gate": n for name, n in zip(COUNT_NAMES, counts)}
    out["gate_s"] = dt
    return out


GATE_RECORD = "GATE_WORDLE_ILQL_r05.json"  # the JAX gate's full-budget run (seed 5)
GATE_STATS = ("behavior_return", "behavior_win", "consistent_ceiling_return", "consistent_ceiling_win")


def _stream_draws(device) -> dict:
    """At the gate's defaults: the first ILQL batch's draws (the second key
    of split(PRNGKey(seed*977 + 13)), B = bsize) and the sampled eval's
    (PRNGKey(seed*31), B = eval batch), with categorical picks from each
    Gumbel: over the words behind a seeded mask, and for the decode slots
    over seeded logits with the padded ids at -inf."""
    args = wordle_ilql_gate.parse_args([])
    n_words = len(WordleVocab.from_file())
    config = wordle_ilql_gate.Gate.trunk_config(args, "bfloat16")
    V = config.padded_vocab_size
    key = threefry.split(threefry.PRNGKey(args.seed * 977 + 13))[1]
    scripted = actor.ScriptedNoise.from_key(key, args.bsize, n_words, device)
    evals = actor.WordleNoise.from_key(threefry.PRNGKey(args.seed * 31), args.eval_batch, V, n_words, device)
    rng = np.random.RandomState(18)
    words = torch.from_numpy(np.where(rng.rand(N_TRIES, 1, n_words) < 0.3, 0.0, -np.inf).astype(np.float32))
    logits = rng.randn(1, 1, 1, V).astype(np.float32)
    logits[..., config.vocab_size:] = -np.inf
    logits = torch.from_numpy(logits)
    return dict(guess=scripted.guess, rand_idx=scripted.rand_idx, uniform=scripted.uniform, env=scripted.env,
                eval_decode=evals.decode, eval_env=evals.env,
                pick_guess=torch.argmax(scripted.guess + words.to(device), dim=-1),
                pick_env=torch.argmax(scripted.env + words.to(device), dim=-1),
                pick_decode=torch.argmax(evals.decode + logits.to(device), dim=-1),
                pick_eval_env=torch.argmax(evals.env + words.to(device), dim=-1))


def _gumbel_rows(name: str, card: torch.Tensor, cpu: torch.Tensor) -> int:
    """Logs the elements where two Gumbel draws differ, with their distance
    in units in the last place (f32 bit patterns), up to 20 rows; returns
    the largest distance."""
    a, b = card.cpu().reshape(-1), cpu.reshape(-1)
    idx = torch.nonzero(a != b).reshape(-1)
    ulps = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
    log(f"stream {name}: {idx.numel()} of {a.numel()} Gumbels differ between the card and the CPU, at most "
        f"{ulps.max().item()} ulp")
    for i in idx[:20].tolist():
        log(f"  {name}[{i}]: card {a[i].item()!r} cpu {b[i].item()!r} ({ulps[i].item()} ulp)")
    return int(ulps.max().item())


def phase_gate_stream(device="cuda") -> dict:
    """Phase 3g's stream checks (slice 18): the JAX-stream draws on the card
    against the CPU's, the Gumbel table, the initial weights and the draw
    times. Integers, uniforms and picks must be equal; a Gumbel more than
    1 ulp off fails, and any that differs is shown row by row. `device`
    stands in for the card in a CPU rehearsal."""
    t0 = time.perf_counter()
    card, cpu = _stream_draws(device), _stream_draws("cpu")
    for name in ("rand_idx", "uniform", "pick_guess", "pick_env", "pick_decode", "pick_eval_env"):
        check(torch.equal(card[name].cpu(), cpu[name]), f"stream {name}: the card's draws differ from the CPU's")
    for name in ("guess", "env", "eval_decode", "eval_env"):
        if not torch.equal(card[name].cpu(), cpu[name]):
            check(_gumbel_rows(name, card[name], cpu[name]) <= 1, f"stream {name}: Gumbels more than 1 ulp apart")
    table_card, table_cpu = threefry._gumbel_table(device).cpu(), threefry._gumbel_table("cpu")
    table_equal = torch.equal(table_card, table_cpu)
    if not table_equal:
        check(_gumbel_rows("table", table_card, table_cpu) <= 1, "the Gumbel tables are more than 1 ulp apart")
    n_draws = sum(card[k].numel() for k in ("guess", "rand_idx", "uniform", "env", "eval_decode", "eval_env"))
    del card, cpu
    args = wordle_ilql_gate.parse_args([])
    config = wordle_ilql_gate.Gate.trunk_config(args, "bfloat16")
    modules = {}
    for d in (device, "cpu"):
        heads = wordle_ilql_gate.Gate.head_modules(args, config, d)
        modules[d] = [init_params_from_key(config, threefry.PRNGKey(args.seed), device=d)]
        modules[d] += [head_from_key(h, k) for h, k in zip(heads, threefry.split(threefry.PRNGKey(2), 3))]
    init_err = max((a.cpu() - b).abs().max().item() for m_card, m_cpu in zip(modules[device], modules["cpu"])
                   for a, b in zip(m_card.state_dict().values(), m_cpu.state_dict().values()))
    check(init_err <= 1e-6, f"the gate's initial trunk and heads differ by {init_err} between the card and the CPU")
    t_check = time.perf_counter() - t0
    n_words = len(WordleVocab.from_file())
    draw_ms = {}
    for B in (512, 2048):
        key = threefry.PRNGKey(B)
        actor.ScriptedNoise.from_key(key, B, n_words, device)
        _sync(device)
        t1 = time.perf_counter()
        for _ in range(10):
            actor.ScriptedNoise.from_key(key, B, n_words, device)
        _sync(device)
        draw_ms[B] = (time.perf_counter() - t1) * 100.0
    log(f"gate stream (3g): card draws as the CPU's ({n_draws} values; Gumbel table of 2^23 "
        f"{'equal' if table_equal else 'within 1 ulp'}), initial "
        f"weights within {init_err:.3g}, {t_check:.1f} s; ScriptedNoise draws {draw_ms[512]:.2f} ms per 512-episode "
        f"batch, {draw_ms[2048]:.2f} ms per 2,048 (wall, 10 draws each)")
    return {"gate_stream_s": time.perf_counter() - t0, "gate_draw_ms_512": draw_ms[512],
            "gate_draw_ms_2048": draw_ms[2048], "gate_init_err": init_err}


def phase_text_env(serving: ValueRLParams, config) -> dict:
    """Phase 3s: legal-set serving through the host text env, then LMServer."""
    L = config.num_layers
    core = LMCore(config)
    tok = ByteTokenizer()
    server = ValueGuidedServer(core, tok, beta=32.0)
    vocab = WordleVocab.from_file()
    proposals = [" ".join(w) + "\n" for w in vocab.words]
    sampling = SamplingConfig(max_new_tokens=10, eos_token_id=10, pad_token_id=256)
    calls: list = []

    def generate_batch(prompts, generator):
        calls.append(len(prompts))
        return server.generate_from_strs_legal(serving, prompts, [proposals] * len(prompts), actor.EPISODE_LEN,
                                               sampling, generator)

    policy = GenerationPolicy(generate_batch, torch.Generator(device="cuda").manual_seed(11))
    env = ReformatWordleEnv(WordleEnv(vocab))
    _reset_counts()
    t0 = time.perf_counter()
    interactions, summary = text_env_eval(env, policy, n_rollouts=8, seed_generator=iter(range(8)), bsize=8)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, n = _all_counts(), len(calls)
    want = (2 * L * n, 2 * L * n, 20 * L * n, 0, 0, 0, 0)  # per turn: two trunks' prefill and 10 decode steps
    check(counts == want, f"text env: {_fmt_counts(counts)} over {n} turns, want {want}")
    check(len(interactions) == 8, f"text env: {len(interactions)} games")
    legal = set(proposals)
    for g, game in enumerate(interactions):
        check(1 <= len(game) <= N_TRIES and game[-1].done, f"text env game {g}: {len(game)} turns, done={game[-1].done}")
        for tr in game:
            action = tr.post_action_history[-1]
            check(action.is_action and action.text in legal, f"text env game {g}: action {action.text!r} is not a vocab word")
    log(f"text env: 8 ReformatWordleEnv games in {dt:.3f} s over {n} policy turns (batches {calls}), "
        f"{_fmt_counts(counts)}; return mean {summary['reward']['mean']:.3f} min {summary['reward']['min']:.1f} "
        f"max {summary['reward']['max']:.1f}, length mean {summary['length']['mean']:.2f}")
    log(f"  game 0: {' | '.join(tr.post_action_history[-1].text.strip() for tr in interactions[0])}")
    per_turn = {f"{name}_text_env_turn": c // n for name, c in zip(COUNT_NAMES, counts) if c}
    per_turn["decode_attn_split_text_env_turn"] = counts.split // n

    lm = LMServer(core, tok)
    prompts = ["Wordle:\n", "Wordle:\nc r a n e\nb b y b g\n", "Wordle:\ns l a t e\ng b b b y\n", "hello"]
    _reset_counts()
    t0 = time.perf_counter()
    answers = lm.generate_from_strs(serving.base, prompts, 48,
                                    SamplingConfig(max_new_tokens=10, greedy=True, eos_token_id=10, pad_token_id=256))
    torch.cuda.synchronize()
    counts = _all_counts()
    check(len(answers) == len(prompts) and all(isinstance(a, str) for a in answers), "LMServer answers")
    check(counts == (L, L, 10 * L, 0, 0, 0, 0), f"LMServer launched {_fmt_counts(counts)}")
    log(f"LMServer: {len(answers)} answers in {time.perf_counter() - t0:.3f} s, {_fmt_counts(counts)}: {answers}")
    return per_turn


def phase_card_vs_cpu(base, config) -> float:
    """Header prefill + 3 decode steps, B=4: card (bf16, kernels) vs CPU (f32, plain).
    The CPU model is a fresh f32 Transformer under the f32 config, built and
    given the card model's weights on the card, then moved to the CPU (its
    draw on the CPU took 15 s for GPT-J's embeddings and lm_head at 2
    layers)."""
    b = 4
    cpu_cfg = config.replace(dtype="float32")
    cpu_model = Transformer(cpu_cfg, device="cuda")
    cpu_model.load_state_dict({k: v.float() for k, v in base.state_dict().items()})
    cpu_model = cpu_model.to("cpu")
    runs = []
    for model, cfg, device in ((base, config, "cuda"), (cpu_model, cpu_cfg, "cpu")):
        step_fn, cache = actor.make_lm_step_fn(LMCore(cfg, device=device), b)
        toks = [torch.tensor(actor.HEADER, device=device).expand(b, -1)]
        toks += [torch.full((b, 1), t, device=device) for t in (99, 32, 114)]  # "c r"
        logits = []
        with torch.inference_mode():
            for tk in toks:
                out, cache = step_fn(model, tk, cache)
                logits.append(out[:, -1, : config.vocab_size].float().cpu())
        runs.append(torch.stack(logits))
    err = (runs[0] - runs[1]).abs().max().item()
    log(f"card (bf16, kernels) vs CPU (f32, plain), B={b}, prefill + 3 steps: max logit diff {err:.4f} "
        f"(tol {LOGIT_TOL}; logits span {runs[1].min().item():.2f}..{runs[1].max().item():.2f})")
    check(err <= LOGIT_TOL, f"card vs CPU logits differ by {err}")
    return err


def _train_batch(device="cuda", b=TRAIN_B, t=TRAIN_T, nt=NEXT_T, seed=0) -> ILQLBatch:
    """bench.py's ILQL batch: random byte tokens, actions on every other
    token with reward −1 each, no episode done, a next window of nt tokens
    whose episode is done."""
    g = torch.Generator().manual_seed(seed)
    sta = torch.zeros(b, t - 1, dtype=torch.bool)
    sta[:, 1::2] = True
    batch = ILQLBatch(
        input_ids=torch.randint(1, 256, (b, t), generator=g), should_take_action=sta, rewards=-1.0 * sta.float(),
        dones=torch.zeros(b, dtype=torch.bool), next_token_ids=torch.randint(1, 256, (b, nt), generator=g),
        next_dones=torch.ones(b, dtype=torch.bool),
    )
    return ILQLBatch(*(x.to(device) for x in batch))


def _train_modules(config, device, seed=0, layer2_initializer_range=0.0):
    """Trunk (f32 parameters) and the twin MLP Q heads and V head at hidden
    2·D, second layer zero-initialized as bench.py builds them."""
    D = config.hidden_size
    q_cfg = MLPHeadConfig(D, 2 * D, config.padded_vocab_size, layer2_initializer_range=layer2_initializer_range)
    v_cfg = MLPHeadConfig(D, 2 * D, 1, layer2_initializer_range=layer2_initializer_range)
    return (init_params(config, seed=seed, device=device), MLPHead(q_cfg, device=device, seed=seed + 1),
            MLPHead(q_cfg, device=device, seed=seed + 2), MLPHead(v_cfg, device=device, seed=seed + 3))


# 3b: the port's measurement scripts. bench.main's timed reps per section
# (BENCH_REPS) cut to 3 from bench.py's 20 (bench_ilql), 5 (bench_actor),
# 10 (bench_ilql_real_vocab) and 20 (bench_env); bench_actor_real_vocab and
# bench_actor_markov keep their 3. Their numbers at the full reps come from
# `python -m lmrl_gym_torch.scripts.bench` (PERF.md)
BENCH_REPS = 3
COUNTED_B, COUNTED_T = 2, 32  # counted_flops on the card against the CPU: profile_ilql's config, a batch the CPU steps in seconds


@contextlib.contextmanager
def recorded_scripts(record: dict, sections: dict):
    """Wraps what the port's bench, profile and scaling scripts call, so each
    call records its launch counts (set to 0 just before it, read just
    after it, with no synchronization added) under the running section:
    record[section] is a list of {kind, counts, result, args, L}. The
    sections are bench's (`port_bench.<name>`, as `main` looks them up),
    each timed and its launches counted whole into sections[name]; the
    calls are the ILQL train steps `make_ilql_train_step` makes,
    `actor.rollout_wordle` and `actor.rollout_markov`."""
    from lmrl_gym_torch.algos import ilql as ilql_module

    current = ["(outside a bench section)"]
    saved = []

    def patch(module, name, wrapper):
        saved.append((module, name, getattr(module, name)))
        setattr(module, name, wrapper(getattr(module, name)))

    def call(kind, fn, layers):
        def wrapped(*args, **kw):
            _reset_counts()
            out = fn(*args, **kw)
            record.setdefault(current[0], []).append(dict(kind=kind, counts=_all_counts(), result=out, args=args,
                                                          L=layers(args)))
            return out
        return wrapped

    def make_step(make):
        def wrapped(core, *args, **kw):
            return call("ilql_step", make(core, *args, **kw), lambda _: core.config.num_layers)
        return wrapped

    def section(name):
        def wrap(fn):
            def wrapped(**kw):
                current[0] = name
                _reset_counts()
                t0 = time.perf_counter()
                out = fn(**kw)
                sections[name] = dict(result=out, s=time.perf_counter() - t0, counts=_all_counts())
                current[0] = "(outside a bench section)"
                return out
            return wrapped
        return wrap

    try:
        patch(ilql_module, "make_ilql_train_step", make_step)
        patch(actor, "rollout_wordle", lambda fn: call("rollout_wordle", fn, lambda a: a[2].config.num_layers))
        patch(actor, "rollout_markov", lambda fn: call("rollout_markov", fn, lambda a: a[3].config.num_layers))
        for name in port_bench.MODES["all"]:
            patch(port_bench, name, section(name))
        yield current
    finally:
        for module, name, fn in reversed(saved):
            setattr(module, name, fn)


def _check_steps(label: str, calls: list) -> None:
    """Every recorded ILQL step: 3L / L / L launches, all on the tensor
    cores, and a finite loss."""
    check(calls and all(c["kind"] == "ilql_step" for c in calls), f"{label}: no ILQL steps recorded")
    for i, c in enumerate(calls):
        want = _want(c["L"], fwd=3, bwd=1)
        check(c["counts"] == want, f"{label} step {i}: {_fmt_counts(c['counts'])}, want {want}")
    losses = torch.stack([c["result"][1] for c in calls]).cpu()
    check(bool(torch.isfinite(losses).all()), f"{label}: losses {losses.tolist()}")


def start_cpu_count() -> subprocess.Popen:
    """`counted_flops` on the CPU at profile_ilql's config (B=COUNTED_B,
    T=COUNTED_T), in a process of its own: the CPU's full-width ILQL state
    and step take seconds, spent beside phase 2's kernel checks. Its
    stdout's last line is the count; `phase_bench` reads it."""
    code = ("import json, torch\n"
            "torch.set_num_threads(4)\n"
            "from lmrl_gym_torch.scripts import profile_ilql as p\n"
            "c = p.profile_config(50257)\n"
            f"state, step, batch = p.build_step(50257, {COUNTED_B}, {COUNTED_T}, 'cpu')\n"
            "print(json.dumps(p.counted_flops(step, state, batch, c)))\n")
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))


def phase_bench(cpu_count: subprocess.Popen, device="cuda") -> dict:
    """Phase 3b: the port's measurement scripts on the card. `bench.main`
    over all six sections (BENCH_REPS timed reps each), every call's
    launches checked (each ILQL step 3L / L / L on the tensor cores; each
    Wordle rollout 7L K1 and 60L K4, no split route; each Markov rollout 8L
    K1 and 8·ACT_LEN·L K4, and its invariants; bench_env none) and each
    section's numbers on a line of their own. 3k's Markov rollouts are
    bench_actor_markov's (one of each profiled after it), and 3t's timed
    ILQL steps are bench_ilql_real_vocab's. Then `profile_ilql.main` at its
    defaults (its steps' launches checked the same way), `counted_flops`
    on the card against the CPU's (`start_cpu_count`) at the profile's
    config (B=COUNTED_B, T=COUNTED_T). `scaling.main`'s rows run in phase
    3x's group (`_scaling_rows`)."""
    record, sections, out = {}, {}, {}
    with recorded_scripts(record, sections) as current, mock.patch.dict(os.environ, BENCH_REPS=str(BENCH_REPS)):
        t0 = time.perf_counter()
        result = port_bench.main(["--device", device])
        log(f"3b bench.main (all six sections, BENCH_REPS={BENCH_REPS}): {time.perf_counter() - t0:.1f} s")
        current[0] = "profile_ilql"
        t0 = time.perf_counter()
        profile = profile_ilql.main(["--device", device])
        log(f"3b profile_ilql.main: {time.perf_counter() - t0:.1f} s")
    check(set(sections) == set(port_bench.MODES["all"]) and result == {k: v for sec in sections.values()
                                                                           for k, v in sec["result"].items()},
          f"3b: bench ran {sorted(sections)}")
    for name in port_bench.MODES["all"]:
        calls, sec = record.get(name, []), sections[name]
        if name.startswith("bench_ilql"):
            _check_steps(name, calls)
            check(len(calls) == 1 + BENCH_REPS, f"{name}: {len(calls)} steps")
        elif name == "bench_env":
            check(not calls and sec["counts"] == (0,) * len(COUNT_NAMES), f"bench_env: {_fmt_counts(sec['counts'])}")
        else:
            per_env = 2 if name == "bench_actor_markov" else 1
            check(len(calls) == per_env * (1 + BENCH_REPS), f"{name}: {len(calls)} rollouts")
            for i, c in enumerate(calls):
                env = c["args"][0]
                if name == "bench_actor_markov":
                    ro, env_name = c["result"][0], ("maze" if isinstance(env, MazeTokenVecEnv) else "chess")
                    want = _want(c["L"], fwd=port_bench.MARKOV_TURNS, dec=port_bench.MARKOV_TURNS * env.ACT_LEN)
                    _check_markov_rollout(ro, env_name, env, ro.turn_live.shape[0], port_bench.MARKOV_TURNS)
                else:
                    want = _want(c["L"], fwd=7, dec=60)
                    _check_rollout(c["result"], env, c["result"].tokens.shape[0], constrained=False)
                check(c["counts"] == want and c["counts"].split == 0,
                      f"{name} rollout {i}: {_fmt_counts(c['counts'])} split {c['counts'].split}, want {want}")
        per_call = f"; launches per call {_fmt_counts(calls[-1]['counts'])}" if calls else ""
        log(f"bench {name} (3b): {json.dumps(sec['result'])} in {sec['s']:.1f} s{per_call}")

    # 3k: the Markov rollouts are bench_actor_markov's: per env, its timed
    # rollouts' launches and one more rollout profiled
    markov = record["bench_actor_markov"]
    for k, env_name in enumerate(("maze", "chess")):
        calls = markov[k * (1 + BENCH_REPS): (k + 1) * (1 + BENCH_REPS)]
        env = calls[0]["args"][0]
        check(isinstance(env, MazeTokenVecEnv) == (env_name == "maze"), "3k: the rollouts' envs out of order")
        steps_per_s = sections["bench_actor_markov"]["result"][f"fused_{env_name}_actor_env_steps_per_s_per_chip"]
        dt = calls[-1]["result"][0].turn_live.shape[0] * port_bench.MARKOV_TURNS / steps_per_s
        log(f"markov rollout (3k) {env_name}: bench_actor_markov's {BENCH_REPS} timed rollouts, "
            f"env_steps_per_s={steps_per_s:.1f} ({dt:.4f} s a rollout); {_fmt_counts(calls[-1]['counts'])}")
        args = calls[-1]["args"]
        if device == "cuda":
            profile_run(f"markov rollout {env_name}", lambda: actor.rollout_markov(*args, generator=torch.Generator(
                device=device).manual_seed(1)), dt)
        out.update(_path_counts(f"markov_{env_name}", calls[-1]["counts"]))
        out[f"markov_{env_name}_s"] = dt

    _check_steps("profile_ilql", record["profile_ilql"])
    p = profile["profile"]
    log(f"profile_ilql (3b): {profile['model']} step_wall_ms={profile['step_wall_ms']} "
        f"updates_per_s={profile['updates_per_s']} counted_flops={profile['counted_flops']} "
        f"counted_mfu_pct={profile['counted_mfu_pct']} profile " + (json.dumps(
            {k: v for k, v in p.items() if k != "top10_ops_ms"}) if isinstance(p, dict) else p))
    config = profile_ilql.profile_config(50257)
    state, step, batch = profile_ilql.build_step(50257, COUNTED_B, COUNTED_T, device)
    card = profile_ilql.counted_flops(step, state, batch, config)
    del state, step, batch
    try:
        stdout, stderr = cpu_count.communicate(timeout=300)
    finally:
        cpu_count.kill()
    check(cpu_count.returncode == 0, f"counted_flops on the CPU failed: {stderr[-2000:]}")
    cpu = json.loads(stdout.strip().splitlines()[-1])
    log(f"counted_flops (3b) at {profile['model'].split(' B')[0]} B={COUNTED_B} T={COUNTED_T}: {device} {card}, "
        f"cpu {cpu}")
    check(card == cpu, f"counted_flops: {device} {card} against the CPU's {cpu}")

    real = record["bench_ilql_real_vocab"]
    out.update(train_steps=real, train_result=sections["bench_ilql_real_vocab"]["result"])
    return out


def phase_train(config, steps: list, bench_result: dict) -> dict:
    """Phase 3t: the ILQL train step at bench.py::bench_ilql_real_vocab's
    operating point, timed by the port bench's section in 3b (`steps`:
    its warm-up and timed steps, each with its launches checked there;
    the step profiled by profile_ilql in 3b), then three BC steps on the
    same trunk."""
    L = config.num_layers
    state, batch = steps[-1]["result"][0], steps[-1]["args"][1]
    c = steps[-1]["counts"]
    step_counts = (c[0], c[3], c[5], c[4], c[6], c[1])  # K1, K2, K3, then K2, K3 and K1 on the tensor cores
    losses = [round(float(s["result"][1]), 4) for s in steps]
    flops = ilql_update_flops(config, TRAIN_B, TRAIN_T, NEXT_T, port_bench.n_params(state.base.params),
                              port_bench.n_params(state.q1_head.params), port_bench.n_params(state.v_head.params))
    ups = bench_result["ilql_updates_per_s_vocab50257"]
    log(f"ILQL train (3t; bench_ilql_real_vocab's {len(steps) - 1} timed steps in 3b): updates_per_s={ups:.3f} "
        f"tokens_per_s={bench_result['ilql_tokens_per_s_vocab50257']:.1f} "
        f"mfu={flops * ups / PEAK_FLOPS[torch.bfloat16]:.4f} (bench.py's count {flops / 1e12:.3f} TFLOP per update "
        f"over 989 TF/s); launches per step {_fmt_counts(c)}; losses {losses}")

    core = LMCore(config)
    bc_state = BCTrainState(TrainState(state.base.params, adamw(1e-4)))
    bc_step = make_bc_train_step(core, BCConfig(), PAD_ID)
    training_mask = torch.zeros(TRAIN_B, TRAIN_T, dtype=torch.int32, device="cuda")
    training_mask[:, 2::2] = 1  # the action tokens of the ILQL batch
    bc_batch = BCBatch(batch.input_ids, training_mask)
    for i in range(3):
        _reset_counts()
        t0 = time.perf_counter()
        bc_state, bc_loss, _ = bc_step(bc_state, bc_batch)
        torch.cuda.synchronize()
        counts = _train_counts()
        check(counts == (L, L, L), f"BC step launched {counts}, want {(L, L, L)}")
        check(_tc_counts() == (L, L), f"BC step: tensor-core backward launches {_tc_counts()}, want {(L, L)}")
        check(flash_fwd.tc_launches == L, f"BC step: tensor-core forward launches {flash_fwd.tc_launches}, want {L}")
        check(bool(torch.isfinite(bc_loss)), f"BC loss {bc_loss.item()}")
        log(f"BC step {i} B={TRAIN_B} T={TRAIN_T}: {time.perf_counter() - t0:.4f} s, loss {bc_loss.item():.4f}, "
            f"launches {counts}, tensor-core backward {_tc_counts()}, forward {flash_fwd.tc_launches}")
    names = ("flash_fwd_train_step", "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dq_tc", "flash_bwd_dkv_tc",
             "flash_fwd_tc_train_step")
    return dict(zip(names, step_counts))


def phase_train_card_vs_cpu(config) -> None:
    """One full-width ILQL step's loss and gradients, f32, B=2, T=32: the
    card (kernels) against the CPU (plain versions). Heads with a nonzero
    second layer, so every group's gradient is nonzero."""
    cfg = config.replace(dtype="float32")
    modules = _train_modules(cfg, "cuda", seed=5, layer2_initializer_range=None)  # drawn on the card: seconds faster
    batch = _train_batch("cpu", b=2, t=32, nt=8, seed=1)
    runs = []
    for d in ("cuda", "cpu"):
        mods = [copy.deepcopy(m).to(d) for m in modules]
        state = init_ilql_state(*mods, adamw(1e-4), adamw(1e-3), ILQLConfig())
        _reset_counts()
        loss, _, grads = ilql_loss_and_grads(LMCore(cfg, device=d), state, ILQLBatch(*(x.to(d) for x in batch)),
                                             ILQLConfig(), PAD_ID)
        if d == "cuda":
            L = cfg.num_layers
            check(_train_counts() == (3 * L, L, L), f"card step launches {_train_counts()}")
            check(_tc_counts() == (0, 0), f"f32 card step: tensor-core backward launches {_tc_counts()}, want none")
            check(flash_fwd.tc_launches == 0, f"f32 card step: tensor-core forward launches {flash_fwd.tc_launches}, want none")
        runs.append((loss.item(), [{k: g.cpu() for k, g in group.items()} for group in grads]))
        del state, mods
    _compare_card_cpu("ILQL step", runs, ("base", "q1", "q2", "v"))


# ---------------- slice 6: MC, CQL, PPO, reranking, the maze gate ----------------

SLICE6_REPS = 2  # timed steps of the MC and CQL steps (after one warm-up)
PPO_EPISODES, PPO_BSIZE, PPO_MAX_STEPS = 32, 16, 8  # maze episodes cut to 8 moves (+ the failure turn)
MAZE_GATE_ARGS = ["--n-chains", "50", "--bc-epochs", "1", "--ilql-epochs", "2", "--lr-warmdown", "--guided-legal"]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _counted(fn, *args, device="cuda", **kwargs):
    """fn(*args, **kwargs) with every launch counter set to 0 just before
    the call and read just after it: (result, counts, seconds)."""
    _reset_counts()
    t0 = time.perf_counter()
    res = fn(*args, **kwargs)
    _sync(device)
    return res, _all_counts(), time.perf_counter() - t0


def _want(L: int, fwd: int = 0, dec: int = 0, bwd: int = 0) -> tuple:
    """Expected counts in COUNT_NAMES' order for `fwd` trunk forwards,
    `dec` single-token decode steps and `bwd` trunk backwards of L layers,
    every K1-K3 launch on the tensor-core variant (bf16: Dh up to 128, and
    K1 at GPT-J's 256)."""
    return (fwd * L, fwd * L, dec * L, bwd * L, bwd * L, bwd * L, bwd * L)


def _path_counts(path: str, counts: tuple) -> dict:
    out = {f"{name}_{path}": n for name, n in zip(COUNT_NAMES, counts)}
    if isinstance(counts, _Counts):
        out[f"decode_attn_split_{path}"] = counts.split
    return out


def _timed_steps(label: str, step, state, batch, want: tuple, device="cuda") -> dict:
    """One warm-up, SLICE6_REPS steps each with its exact launch counts and
    a finite loss, then one step under torch.profiler. Returns the last
    step's counts, updates per second and peak memory."""
    state, loss, _ = step(state, batch)
    check(bool(torch.isfinite(loss)), f"{label}: warm-up loss {loss.item()}")
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses = []
    t_all = time.perf_counter()
    for i in range(SLICE6_REPS):
        _reset_counts()
        state, loss, logs = step(state, batch)
        counts = _all_counts()
        check(counts == want, f"{label} step {i}: {_fmt_counts(counts)}, want {want}")
        losses.append(loss)
    _sync(device)
    dt = time.perf_counter() - t_all
    losses = torch.stack(losses).cpu()
    check(bool(torch.isfinite(losses).all()), f"{label}: losses {losses.tolist()}")
    peak = torch.cuda.max_memory_allocated() / 1e9 if torch.device(device).type == "cuda" else 0.0
    ups = SLICE6_REPS / dt
    log(f"{label}: {SLICE6_REPS} steps in {dt:.4f} s: updates_per_s={ups:.3f} "
        f"tokens_per_s={ups * batch.input_ids.numel():.1f} peak_mem_gb={peak:.2f}; per step {_fmt_counts(counts)}; "
        f"losses {[round(x, 4) for x in losses.tolist()]}; "
        + " ".join(f"{k}={v.item():.4f}" for k, v in logs["losses"].items()))
    profile_run(label, lambda: step(state, batch), dt / SLICE6_REPS)
    return dict(counts=counts, updates_per_s=ups, peak_mem_gb=peak)


def _compare_card_cpu(label: str, runs, names, card_dtype: str = "f32",
                      tols: tuple = (STEP_LOSS_RTOL, STEP_GRAD_RTOL)) -> None:
    """Loss within tols[0] relative, each group's gradient within tols[1] in
    relative norm (card first, CPU second in `runs`; by default the f32
    step's STEP_LOSS_RTOL and STEP_GRAD_RTOL)."""
    (l_card, g_card), (l_cpu, g_cpu) = runs
    loss_rtol, grad_rtol = tols
    rel_loss = abs(l_card - l_cpu) / abs(l_cpu)
    rel = {}
    for name, ga, gb in zip(names, g_card, g_cpu):
        num = sum(((ga[k] - gb[k]).double() ** 2).sum() for k in gb) ** 0.5
        den = sum((gb[k].double() ** 2).sum() for k in gb) ** 0.5
        rel[name] = float(num / den)
    log(f"{label} card ({card_dtype}, kernels) vs CPU (f32, plain), full width B=2 T=32: loss {l_card:.6f} vs "
        f"{l_cpu:.6f} (rel {rel_loss:.2e}, tol {loss_rtol}); gradient rel norm diff "
        + " ".join(f"{k}={v:.2e}" for k, v in rel.items()) + f" (tol {grad_rtol})")
    check(rel_loss <= loss_rtol, f"{label}: card vs CPU loss rel diff {rel_loss}")
    for name, r in rel.items():
        check(r <= grad_rtol, f"{label}: card vs CPU {name} gradient rel diff {r}")


def _mc_batch(device="cuda", b=TRAIN_B, t=TRAIN_T, seed=0) -> MCBatch:
    """bench.py's token layout (actions on every other token) with a
    reward-to-go in [-5, 0] on each action token."""
    g = torch.Generator().manual_seed(seed)
    sta = torch.zeros(b, t - 1, dtype=torch.bool)
    sta[:, 1::2] = True
    batch = MCBatch(torch.randint(1, 256, (b, t), generator=g), sta, -5.0 * torch.rand(b, t - 1, generator=g) * sta)
    return MCBatch(*(x.to(device) for x in batch))


def phase_mc(config, device="cuda") -> dict:
    """Phase 3m: the MC-returns step at the ILQL step's operating point
    (GPT-2-small, f32 parameters, bf16 activations, one MLP Q head, AdamW,
    B=32, T=160), then one full-width f32 step on the card against the CPU."""
    L = config.num_layers
    base, q, _, _ = _train_modules(config, device)
    state = MCTrainState(TrainState(base, adamw(1e-4)), TrainState(q, adamw(1e-3)))
    step = make_mc_train_step(LMCore(config, device=device), MCConfig(), PAD_ID)
    res = _timed_steps("MC step (3m)", step, state, _mc_batch(device), _want(L, fwd=1, bwd=1), device)
    del state, base, q

    cfg = config.replace(dtype="float32")
    modules = _train_modules(cfg, device, seed=5, layer2_initializer_range=None)[:2]
    batch = _mc_batch("cpu", b=2, t=32, seed=1)
    runs = []
    for d in (device, "cpu"):
        base, q = (copy.deepcopy(m).to(d) for m in modules)
        _reset_counts()
        loss, _ = mc_loss_from_params(LMCore(cfg, device=d), base, q, MCBatch(*(x.to(d) for x in batch)), MCConfig(),
                                      PAD_ID, train=True)
        grads = value_and_grads(loss, (base, q))
        if d != "cpu":
            check(_all_counts() == (L, 0, 0, L, 0, L, 0), f"f32 MC card step: {_fmt_counts(_all_counts())}")
        runs.append((loss.item(), [{k: g.cpu() for k, g in group.items()} for group in grads]))
    _compare_card_cpu("MC step", runs, ("base", "q"))
    return {**_path_counts("mc_step", res["counts"]), "mc_updates_per_s": res["updates_per_s"]}


def phase_cql(config, device="cuda") -> dict:
    """Phase 3c: the CQL step at the ILQL step's operating point, with a
    separate target base and a next window of 16 tokens, then one
    full-width f32 step on the card against the CPU."""
    L = config.num_layers
    base, q1, q2, _ = _train_modules(config, device)
    state = init_cql_state(base, q1, q2, adamw(1e-4), adamw(1e-3), CQLConfig())
    step = make_cql_train_step(LMCore(config, device=device), CQLConfig(), PAD_ID)
    # trained, target and next-window trunk forwards; one backward
    res = _timed_steps("CQL step (3c)", step, state, _train_batch(device), _want(L, fwd=3, bwd=1), device)
    del state, base, q1, q2

    cfg = config.replace(dtype="float32")
    modules = _train_modules(cfg, device, seed=5, layer2_initializer_range=None)[:3]
    batch = _train_batch("cpu", b=2, t=32, nt=8, seed=1)
    runs = []
    for d in (device, "cpu"):
        state = init_cql_state(*(copy.deepcopy(m).to(d) for m in modules), adamw(1e-4), adamw(1e-3), CQLConfig())
        _reset_counts()
        loss, _ = cql_forward(LMCore(cfg, device=d), state.base.params, state.target_base_params, state.q1_head.params,
                              state.q2_head.params, state.q1_target_params, state.q2_target_params,
                              ILQLBatch(*(x.to(d) for x in batch)), CQLConfig(), PAD_ID, train=True)
        grads = value_and_grads(loss, (state.base.params, state.q1_head.params, state.q2_head.params))
        if d != "cpu":
            check(_all_counts() == (3 * L, 0, 0, L, 0, L, 0), f"f32 CQL card step: {_fmt_counts(_all_counts())}")
        runs.append((loss.item(), [{k: g.cpu() for k, g in group.items()} for group in grads]))
        del state
    _compare_card_cpu("CQL step", runs, ("base", "q1", "q2"))
    return {**_path_counts("cql_step", res["counts"]), "cql_updates_per_s": res["updates_per_s"],
            "cql_peak_mem_gb": res["peak_mem_gb"]}


def _maze_config(tok):
    """GPT-2-small's width over the byte tokenizer's vocab (259, padded to
    320), as the JAX maze PPO gate sizes its model to its tokenizer."""
    return gpt2_small().replace(vocab_size=tok.vocab_size, pad_vocab_to_multiple=64, embd_pdrop=0.0,
                                resid_pdrop=0.0, attn_pdrop=0.0)


def phase_ppo(device="cuda", config=None) -> dict:
    """Phase 3p: one PPO round on the maze at GPT-2-small width: LMServer
    rollouts through `GenerationPolicy` and `text_env_eval` (PPO_EPISODES
    episodes at batch PPO_BSIZE), `get_ppo_data_from_chains` through
    `make_ppo_forward_fn`, `block_ppo_data`, then PPO steps at B=32 without
    and with the BC term."""
    tok = ByteTokenizer()
    config = config or _maze_config(tok)
    L, pad = config.num_layers, tok.pad_token_id
    core = LMCore(config, device=device)
    policy = init_params(config, seed=20, device=device)
    init_policy = copy.deepcopy(policy).requires_grad_(False)
    value_head = LinearHead(LinearHeadConfig(config.hidden_size, 1), device=device, seed=21)
    server = LMServer(core, tok)
    sampling = SamplingConfig(max_new_tokens=MAZE_NEW, temperature=1.0, eos_token_id=10, pad_token_id=pad)
    turns = []

    def generate_batch(prompts, generator):
        res, counts, s = _counted(server.generate_from_strs, policy, prompts, MAZE_LEN, sampling, generator,
                                  device=device)
        turns.append(dict(n=len(prompts), counts=counts, s=s))
        return res

    env = build_maze_env(max_steps=PPO_MAX_STEPS)
    pol = GenerationPolicy(generate_batch, torch.Generator(device=device).manual_seed(13))
    t0 = time.perf_counter()
    interactions, summary = text_env_eval(env, pol, n_rollouts=PPO_EPISODES,
                                          seed_generator=iter(range(PPO_EPISODES)), bsize=PPO_BSIZE)
    t_roll = time.perf_counter() - t0
    check(len(interactions) == PPO_EPISODES and all(g and g[-1].done for g in interactions),
          f"PPO rollout: {len(interactions)} episodes, not all done")
    for i, turn in enumerate(turns):
        check(turn["counts"] == _want(L, fwd=1, dec=MAZE_NEW), f"PPO rollout turn {i}: {_fmt_counts(turn['counts'])}")
    log(f"PPO rollout (3p): {PPO_EPISODES} maze episodes at batch {PPO_BSIZE} in {t_roll:.3f} s over {len(turns)} "
        f"LMServer calls (per call {_fmt_counts(turns[0]['counts'])}, median {sorted(t['s'] for t in turns)[len(turns) // 2]:.4f} s); "
        f"return mean {summary['reward']['mean']:.2f} length mean {summary['length']['mean']:.2f}")
    if torch.device(device).type == "cuda":
        hist = [tr.pre_action_history for tr in interactions[0][:1]] * PPO_BSIZE
        profile_run("PPO rollout turn (LMServer, B=16)", lambda: generate_batch(
            [text_history_to_str(h) for h in hist], torch.Generator(device=device).manual_seed(14)), turns[0]["s"])

    chains = []
    for game in interactions:  # per-step Markov windows, chained, as the JAX maze PPO gate builds them
        chain = None
        for tr in reversed(game):
            chain = TextTrajectoryChain(TextTrajectory((tr.pre_action_history[-1], tr.post_action_history[-1]),
                                                       (0.0, tr.reward), tr.done), chain)
        chains.append(TokenTrajectoryChain.from_text_trajectory_chain(chain, tok))
    forward_fn = make_ppo_forward_fn(core, init_policy, policy, value_head, pad)
    fwd_calls = []

    def traced_forward(tokens):
        res, counts, s = _counted(forward_fn, tokens, device=device)
        fwd_calls.append(dict(counts=counts, s=s))
        return res

    t0 = time.perf_counter()
    datas, kls = get_ppo_data_from_chains(traced_forward, tok, chains, TRAIN_B, MAZE_LEN, gamma=0.99, lam=0.95,
                                          kl_weight=0.01)
    t_data = time.perf_counter() - t0
    for i, call in enumerate(fwd_calls):
        check(call["counts"] == _want(L, fwd=2), f"PPO forward call {i}: {_fmt_counts(call['counts'])}")
    check(len(kls) > 0 and bool(np.isfinite(kls).all()), "PPO data: KL estimates not finite")
    for d in datas:
        check(all(bool(np.isfinite(getattr(d, f)).all()) for f in ("old_logprobs", "old_values", "old_advantages",
                                                                   "old_returns")), "PPO data: a non-finite value")
    blocked = block_ppo_data(datas, BlockingStrategy(Padding.RIGHT, Truncation.RIGHT, MAZE_LEN), pad)
    log(f"PPO data (3p): {len(datas)} windows from {len(chains)} chains in {t_data:.3f} s over {len(fwd_calls)} "
        f"forward calls (per call {_fmt_counts(fwd_calls[0]['counts'])}); mean KL {float(np.mean(kls)):.3e}; "
        f"blocked {tuple(blocked['input_ids'].shape)}")

    state = PPOTrainState(TrainState(policy, adamw(1e-5)), TrainState(value_head, adamw(1e-4)))
    w0 = (policy.ln_f.weight.detach().clone(), value_head.dense.weight.detach().clone())
    n = blocked["input_ids"].shape[0]
    check(n >= 4 * TRAIN_B, f"PPO data: {n} windows, want at least {4 * TRAIN_B}")
    out = _path_counts("ppo_rollout_turn", turns[0]["counts"])
    out.update(_path_counts("ppo_forward", fwd_calls[0]["counts"]))
    first_batch = None
    for j, bc_weight in enumerate((0.0, 0.5)):
        step = make_ppo_train_step(core, PPOConfig(gamma=0.99, lam=0.95, bc_loss_weight=bc_weight), pad)
        for i in range(2):
            rows = slice((2 * j + i) * TRAIN_B, (2 * j + i + 1) * TRAIN_B)
            t = {k: torch.from_numpy(v[rows]).to(device) for k, v in blocked.items()}
            bc = {}
            if bc_weight:
                mask = torch.cat((torch.zeros_like(t["should_take_action"][:, :1]), t["should_take_action"]), 1)
                bc = dict(bc_input_ids=t["input_ids"].long(), bc_training_mask=mask.float())
            batch = PPOBatch(t["input_ids"].long(), t["should_take_action"], t["old_logprobs"], t["old_values"],
                             t["old_advantages"], t["old_returns"], **bc)
            if first_batch is None:  # 3q runs the first step again
                first_batch = batch
            (state, loss, logs), counts, s = _counted(step, state, batch, device=device)
            want = _want(L, fwd=2, bwd=2) if bc_weight else _want(L, fwd=1, bwd=1)
            check(counts == want, f"PPO step bc={bc_weight} {i}: {_fmt_counts(counts)}, want {want}")
            kl, vals = logs["policy"]["approx_kl"].item(), logs["values"]["mean"].item()
            check(all(math.isfinite(x) for x in (loss.item(), kl, vals)), f"PPO step: loss {loss.item()} kl {kl} values {vals}")
            log(f"PPO step (3p) bc_weight={bc_weight} {i}: {s:.4f} s, {_fmt_counts(counts)}, loss {loss.item():.4f} "
                f"approx_kl {kl:.3e} values~{vals:.3f}" + (f" bc_loss {logs['bc_loss'].item():.4f}" if bc_weight else ""))
        out.update(_path_counts("ppo_step_bc" if bc_weight else "ppo_step", counts))
        if torch.device(device).type == "cuda":
            profile_run(f"PPO step bc_weight={bc_weight}", lambda: step(state, batch), s)
    check(not torch.equal(w0[0], policy.ln_f.weight) and not torch.equal(w0[1], value_head.dense.weight),
          "PPO steps: the policy or the value head did not move")
    return {**out, "policy": policy, "config": config, "batch": first_batch}


def phase_rerank(policy, config, device="cuda") -> dict:
    """Phase 3r: `ReRankerPolicy` over the maze's four move proposals in
    every cell, scored at GPT-2-small width by `make_ilql_score_fn` (twin Q
    and V; then with a π_β trunk and `logit_weight`) and `make_mc_score_fn`
    (twin Q, mean over the action tokens)."""
    tok = ByteTokenizer()
    L, D = config.num_layers, config.hidden_size
    core = LMCore(config, device=device)
    q_cfg = MLPHeadConfig(D, 2 * D, config.padded_vocab_size)
    q1, q2 = MLPHead(q_cfg, device=device, seed=31), MLPHead(q_cfg, device=device, seed=32)
    v = MLPHead(MLPHeadConfig(D, 2 * D, 1), device=device, seed=33)
    pi_beta = init_params(config, seed=34, device=device)
    maze = double_t_maze()
    cases = (
        ("ilql", make_ilql_score_fn(core, ValueRLParams(None, policy, q1, q2, v), tok.pad_token_id), 1),
        ("ilql+pi_beta", make_ilql_score_fn(core, ValueRLParams(pi_beta, policy, q1, q2, v), tok.pad_token_id,
                                            logit_weight=1.0), 2),
        ("mc", make_mc_score_fn(core, ValueRLParams(None, policy, q1, q2, None), tok.pad_token_id,
                                length_normalize=True), 1),
    )
    out = {}
    for name, score, n_trunks in cases:
        calls = []

        def score_batch(histories):
            ids, am = tokenize_histories_for_scoring(histories, tok, MAZE_LEN, device=device)
            res, counts, s = _counted(score, ids, am, device=device)
            calls.append(dict(counts=counts, s=s, n=len(histories), ids=ids, am=am))
            return res.cpu().numpy()

        reranker = ReRankerPolicy(proposal_fn=lambda h: [h + (Text(a, True),) for a in ACTION_STRS],
                                  score_batch=score_batch)
        acc, per_cell = per_cell_optimal_move_accuracy(lambda hs: reranker.act(hs), maze, (8, 6))
        check(0.0 <= acc <= 1.0 and all(a in ACTION_STRS for a, _ in per_cell.values()),
              f"rerank {name}: an action outside the proposals")
        for i, call in enumerate(calls):
            check(call["counts"] == _want(L, fwd=n_trunks), f"rerank {name} call {i}: {_fmt_counts(call['counts'])}")
        log(f"rerank (3r) {name}: accuracy {acc:.3f} over {len(per_cell)} cells, {len(calls)} score calls of "
            f"{calls[0]['n']} proposals, {calls[0]['s']:.4f} s, {_fmt_counts(calls[0]['counts'])}")
        if torch.device(device).type == "cuda":
            profile_run(f"score call {name}", lambda: score(calls[0]["ids"], calls[0]["am"]), calls[0]["s"])
        out.update(_path_counts("score_call" if name == "ilql" else f"score_call_{name.replace('+', '_')}",
                                calls[0]["counts"]))
    return out


def phase_maze_gate(device="cuda", extra=()) -> dict:
    """Phase 3z: the port's maze gate at its own width (d256 L4 H4, byte
    vocab) and a cut budget (MAZE_GATE_ARGS), --algo cql then --algo mc:
    exact launch counts for the budget and accuracies in [0, 1]."""
    args = maze_ilql_gate.parse_args(MAZE_GATE_ARGS + list(extra) + ["--device", device])
    L = args.layers
    chains = generate_maze_chains(args.n_chains, seed=args.seed, p_optimal=args.p_optimal, wrong_bias=True)
    n_windows = sum(len(c.to_list()) for c in chains)
    n_batches = -(-n_windows // args.bsize)
    n_evals = len([e for e in range(1, args.ilql_epochs + 1) if e % args.eval_every == 0 or e == args.ilql_epochs])
    out = {}
    for algo, value_fwd in (("cql", 3), ("mc", 1)):
        bc = _want(L, fwd=n_batches * args.bc_epochs, bwd=n_batches * args.bc_epochs)
        bc_eval = _want(L, fwd=1, dec=MAZE_NEW)  # LMServer over the 25 cells
        value = _want(L, fwd=value_fwd * n_batches * args.ilql_epochs, bwd=n_batches * args.ilql_epochs)
        # per eval: the two-trunk legal-set guided decode, two reranker score calls
        evals = _want(L, fwd=n_evals * (2 + 2), dec=n_evals * 2 * MAZE_NEW)
        want = tuple(sum(x) for x in zip(bc, bc_eval, value, evals))
        g = maze_ilql_gate.Gate(maze_ilql_gate.parse_args(MAZE_GATE_ARGS + list(extra) + ["--algo", algo,
                                                                                           "--device", device]))
        result, counts, s = _counted(maze_ilql_gate.run, g, device=device)
        check(counts == want, f"maze gate {algo}: {_fmt_counts(counts)}, want {want}")
        accs = [result["bc_acc"]] + [c[k] for c in result["curve"][1:] for k in ("acc", "rerank_acc", "target_rerank_acc")]
        check(len(result["curve"]) == 1 + n_evals and all(0.0 <= a <= 1.0 for a in accs),
              f"maze gate {algo}: curve {result['curve']}")
        log(f"maze gate (3z) --algo {algo} ({' '.join(MAZE_GATE_ARGS + list(extra))}): {s:.1f} s, {n_windows} windows, "
            f"{n_batches} batches per epoch, {_fmt_counts(counts)}; curve {result['curve']}")
        out.update(_path_counts(f"maze_gate_{algo}", counts))
        out[f"maze_gate_{algo}_s"] = s
    return out


# ---------------- slice 7: PPO on Text-Nav, the train loops, the PPO gates ----------------

TN_EPISODES, TN_MAX_STEPS = 16, 4  # 3n: Text-Nav episodes at batch 16, cut to 4 turns
LOOP_STEPS = 2  # 3l: uninterrupted offline-loop epochs (one B=32 batch each)
RESUME_RTOL = 1e-6
TN_GATE_ARGS = ["--n-episodes", "8", "--bc-epochs", "1", "--rounds", "2", "--value-warmup-rounds", "1",
                "--rollouts-per-round", "8", "--eval-rollouts", "8", "--max-steps", "8"]
MAZE_PPO_GATE_ARGS = ["--n-chains", "10", "--bc-epochs", "1", "--rounds", "2", "--value-warmup-rounds", "1",
                      "--rollouts-per-round", "8", "--eval-rollouts", "8"]
MAZE_PPO_GATE_MOVES = 20  # 3w's maze episodes cut to 20 moves (the gate's env allows 100)


def _text_nav_gate(extra=(), device="cuda"):
    """The port's Text-Nav PPO gate at GPT-2-small width (d768 L12 H12)
    over the Text-Nav BPE, windows of TN_LEN tokens at H = 2."""
    args = text_nav_ppo_gate.parse_args(["--hidden", "768", "--layers", "12", "--heads", "12",
                                         "--rollouts-per-round", str(TN_EPISODES), "--max-steps", str(TN_MAX_STEPS),
                                         *extra, "--device", device])
    g = text_nav_ppo_gate.Gate(args)
    check(g.MAX_LEN == TN_LEN and g.config.max_position_embeddings == TN_LEN, f"Text-Nav MAX_LEN {g.MAX_LEN}")
    return g


def phase_text_nav_ppo(device="cuda", extra=()) -> dict:
    """Phase 3n: one PPO round on Text-Nav at GPT-2-small width: LMServer
    rollouts of `TextNavEnv` through the gate's windowed policy (TN_EPISODES
    episodes cut to TN_MAX_STEPS turns, batch 16), the PPO data path on
    TN_LEN-token windows, and four PPO steps at B=32, the last with the BC
    term. Launches worked out from the code before the run: per LMServer
    call one prefill (L K1) and TN_NEW decode steps (L·TN_NEW K4); per
    forward call two trunks (2L K1); per step one forward and one backward
    (L each of K1, K2, K3), the BC step a second of each."""
    g = _text_nav_gate(extra, device)
    L, pad = g.config.num_layers, g.tokenizer.pad_token_id
    policy = init_params(g.config, seed=40, device=device)
    value_head = LinearHead(LinearHeadConfig(g.config.hidden_size, 1), device=device, seed=41)
    turns = []
    generate = g.generate

    def traced_generate(params, prompts, sampling, generator):
        res, counts, s = _counted(generate, params, prompts, sampling, generator, device=device)
        turns.append(dict(n=len(prompts), counts=counts, s=s, prompts=prompts))
        return res

    g.generate = traced_generate
    t0 = time.perf_counter()
    chains, summary = g.rollouts(policy, 0)
    t_roll = time.perf_counter() - t0
    check(len(chains) == TN_EPISODES, f"Text-Nav rollout: {len(chains)} episodes")
    for i, turn in enumerate(turns):
        check(turn["counts"] == _want(L, fwd=1, dec=TN_NEW), f"Text-Nav turn {i}: {_fmt_counts(turn['counts'])}")
    long_prompt = max(len(g.tokenizer.encode(p)) for t in turns for p in t["prompts"])
    log(f"Text-Nav rollout (3n): {TN_EPISODES} episodes at batch 16 in {t_roll:.3f} s over {len(turns)} LMServer calls "
        f"(per call {_fmt_counts(turns[0]['counts'])}, median {sorted(t['s'] for t in turns)[len(turns) // 2]:.4f} s, "
        f"longest prompt {long_prompt} tokens of {TN_LEN}); return mean {summary['reward']['mean']:.3f}")
    if torch.device(device).type == "cuda":
        prompts = turns[-1]["prompts"] * (16 // len(turns[-1]["prompts"]) + 1)
        profile_run("Text-Nav turn (LMServer, B=16, 640-token prompts, 36 new)", lambda: generate(
            policy, prompts[:16], g.rollout_sampling, torch.Generator(device=device).manual_seed(5)), turns[0]["s"])
    g.generate = generate

    state = PPOTrainState(TrainState(policy, adamw(3e-4)), TrainState(value_head, adamw(1e-3)))
    init_policy = copy.deepcopy(policy).requires_grad_(False)
    fwd_calls = []
    forward = make_ppo_forward_fn(g.core, init_policy, policy, value_head, pad)

    def traced_forward(tokens):
        res, counts, s = _counted(forward, tokens, device=device)
        fwd_calls.append(dict(counts=counts, s=s))
        return res

    t0 = time.perf_counter()
    datas, kls = get_ppo_data_from_chains(traced_forward, g.tokenizer, chains, TRAIN_B, TN_LEN, gamma=0.99, lam=0.95,
                                          kl_weight=0.01)
    t_data = time.perf_counter() - t0
    for i, call in enumerate(fwd_calls):
        check(call["counts"] == _want(L, fwd=2), f"Text-Nav PPO forward call {i}: {_fmt_counts(call['counts'])}")
    check(len(kls) > 0 and bool(np.isfinite(kls).all()), "Text-Nav PPO data: KL estimates not finite")
    blocked = block_ppo_data(datas, BlockingStrategy(Padding.RIGHT, Truncation.RIGHT, TN_LEN), pad)
    n = blocked["input_ids"].shape[0]
    log(f"Text-Nav PPO data (3n): {n} windows from {len(chains)} chains in {t_data:.3f} s over {len(fwd_calls)} forward "
        f"calls (per call {_fmt_counts(fwd_calls[0]['counts'])}); blocked {tuple(blocked['input_ids'].shape)}")
    rows = np.arange(4 * TRAIN_B) % n  # four batches of 32 windows (wrapping when the round made fewer)
    w0 = (policy.ln_f.weight.detach().clone(), value_head.dense.weight.detach().clone())
    out = _path_counts("text_nav_turn", turns[0]["counts"])
    out.update(_path_counts("ppo_forward_text_nav", fwd_calls[0]["counts"]))
    for i, bc_weight in enumerate((0.0, 0.0, 0.0, 0.5)):
        step = make_ppo_train_step(g.core, PPOConfig(gamma=0.99, lam=0.95, bc_loss_weight=bc_weight), pad)
        t = {k: torch.from_numpy(v[rows[i * TRAIN_B:(i + 1) * TRAIN_B]]).to(device) for k, v in blocked.items()}
        bc = {}
        if bc_weight:
            mask = torch.cat((torch.zeros_like(t["should_take_action"][:, :1]), t["should_take_action"]), 1)
            bc = dict(bc_input_ids=t["input_ids"].long(), bc_training_mask=mask.float())
        batch = PPOBatch(t["input_ids"].long(), t["should_take_action"], t["old_logprobs"], t["old_values"],
                         t["old_advantages"], t["old_returns"], **bc)
        (state, loss, logs), counts, s = _counted(step, state, batch, device=device)
        want = _want(L, fwd=2, bwd=2) if bc_weight else _want(L, fwd=1, bwd=1)
        check(counts == want, f"Text-Nav PPO step {i} bc={bc_weight}: {_fmt_counts(counts)}, want {want}")
        check(math.isfinite(loss.item()), f"Text-Nav PPO step {i}: loss {loss.item()}")
        log(f"Text-Nav PPO step (3n) {i} bc_weight={bc_weight} B={TRAIN_B} T={TN_LEN}: {s:.4f} s, {_fmt_counts(counts)}, "
            f"loss {loss.item():.4f} approx_kl {logs['policy']['approx_kl'].item():.3e}")
        out.update(_path_counts("ppo_step_text_nav_bc" if bc_weight else "ppo_step_text_nav", counts))
        if torch.device(device).type == "cuda" and i in (0, 3):
            profile_run(f"Text-Nav PPO step bc_weight={bc_weight}", lambda: step(state, batch), s)
    check(not torch.equal(w0[0], policy.ln_f.weight) and not torch.equal(w0[1], value_head.dense.weight),
          "Text-Nav PPO steps: the policy or the value head did not move")
    return out


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path) for f in files)


def _timed_calls(module, name: str, seconds: list):
    """Wrap module.name to append each call's wall seconds to `seconds`;
    returns the function that restores it."""
    fn = getattr(module, name)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        seconds.append(time.perf_counter() - t0)
        return out

    setattr(module, name, timed)
    return lambda: setattr(module, name, fn)


def phase_loops(config, device="cuda", maze_config=None) -> dict:
    """Phase 3l: the generic loops at full width. Offline: `offline_train_loop`
    drives the ILQL step at phase 3t's point (GPT-2-small, vocab 50,304,
    B=32, T=160, one batch per epoch) for LOOP_STEPS epochs, saving the
    seven-module checkpoint with its optimizer state after each epoch; a
    fresh state restored from the first epoch's checkpoint resumes the loop
    (which restarts that epoch, as the JAX loop does), and its first step's
    loss must equal the uninterrupted run's second within RESUME_RTOL (the
    same 32 windows, in another order); the loop's first checkpoint write is
    timed, and the same modules' params written alone. Online: `online_train_loop` runs two
    maze PPO rounds (phase 3p's width) with a round checkpoint. Checkpoints
    go to a temporary directory, deleted afterwards."""
    L = config.num_layers
    core = LMCore(config, device=device)
    ilql_config = ILQLConfig()
    step = make_ilql_train_step(core, ilql_config, PAD_ID)
    cpu_batch = _train_batch("cpu")
    arrays = {k: v.numpy() for k, v in cpu_batch._asdict().items()}

    def batch_prep(b):
        return ILQLBatch(*(torch.from_numpy(np.asarray(b[f])).to(device) for f in ILQLBatch._fields))

    def modules(s):
        return {"base": s.base, "target_base": s.target_base_params, "q1_head": s.q1_head, "q2_head": s.q2_head,
                "v_head": s.v_head, "q1_target_head": s.q1_target_params, "q2_target_head": s.q2_target_params}

    def fresh_state():
        return init_ilql_state(*_train_modules(config, device, seed=7), adamw(1e-4), adamw(1e-3), ilql_config)

    out = {}
    writes: list = []  # seconds of each checkpoint write of the uninterrupted loop
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        runs = {}
        for name in ("uninterrupted", "resumed"):
            losses, step_counts = [], []

            def step_fn(s, b, generator):
                _reset_counts()
                s, loss, logs = step(s, b)
                step_counts.append(_all_counts())
                losses.append(loss.item())
                return s, loss, logs

            state = fresh_state()
            loop_state = None
            save_dir = os.path.join(root, name)
            if name == "resumed":
                ckpt = os.path.join(root, "uninterrupted", "epoch_0")
                t0 = time.perf_counter()
                for mod_name, module in modules(state).items():
                    restore_module(ckpt, mod_name, module)
                _sync(device)
                t_read = time.perf_counter() - t0
                loop_state = LoopState.load(os.path.join(ckpt, "loop_state.pkl"))
                n_bytes = _dir_bytes(ckpt)
                log(f"loops (3l): read the 7-module ILQL checkpoint with optimizer state ({n_bytes / 1e9:.3f} GB) in "
                    f"{t_read:.2f} s ({n_bytes / 1e9 / t_read:.3f} GB/s); loop state step {loop_state.step} epoch "
                    f"{loop_state.epoch}")
                out.update(ckpt_read_s=t_read, ckpt_bytes=n_bytes)
            t0 = time.perf_counter()
            timed_dump = _timed_calls(loop_checkpoints, "dump_modules", writes)
            state, ls = offline_train_loop(
                state, step_fn, ArrayDataset(dict(arrays)),
                OfflineLoopConfig(epochs=LOOP_STEPS, train_bsize=TRAIN_B, log_every=None, eval_every_epochs=None,
                                  save_every_epochs=1 if name == "uninterrupted" else None, save_at_end=False,
                                  save_dir=save_dir, save_train_state=True),
                batch_prep=batch_prep, module_getter=modules, loop_state=loop_state)
            timed_dump()
            _sync(device)
            runs[name] = dict(losses=losses, s=time.perf_counter() - t0, ls=(ls.step, ls.epoch))
            for i, c in enumerate(step_counts):
                check(c == _want(L, fwd=3, bwd=1), f"offline loop {name} step {i}: {_fmt_counts(c)}")
            check(all(math.isfinite(x) for x in losses), f"offline loop {name}: losses {losses}")
            del state
        un, re = runs["uninterrupted"], runs["resumed"]
        ckpt_dir = os.path.join(root, "uninterrupted")
        check(sorted(os.listdir(ckpt_dir)) == [f"epoch_{i}" for i in range(LOOP_STEPS)], f"checkpoints {os.listdir(ckpt_dir)}")
        rel = abs(re["losses"][0] - un["losses"][1]) / abs(un["losses"][1])
        log(f"loops (3l) offline ILQL: uninterrupted {LOOP_STEPS} epochs in {un['s']:.2f} s (two checkpoint writes "
            f"included), losses {un['losses']}; resumed from epoch_0 (step 1): losses {re['losses']}, loop state "
            f"{re['ls']}; first resumed step vs the uninterrupted step 2: rel diff {rel:.2e} (tol {RESUME_RTOL}); "
            f"per step {_fmt_counts(step_counts[0])}")
        check(rel <= RESUME_RTOL, f"offline loop resume: first step's loss {re['losses'][0]} vs {un['losses'][1]}")
        check(re["ls"] == (LOOP_STEPS + 1, LOOP_STEPS), f"resumed loop state {re['ls']}")
        # the loop's first checkpoint write, timed (3i times the same seven modules' params alone)
        t_write, n_bytes = writes[0], _dir_bytes(os.path.join(ckpt_dir, "epoch_0"))
        log(f"loops (3l): wrote the 7-module ILQL checkpoint with optimizer state ({n_bytes / 1e9:.3f} GB) in "
            f"{t_write:.2f} s ({n_bytes / 1e9 / t_write:.3f} GB/s)")
        out.update(ckpt_write_s=t_write)
        out.update(_path_counts("offline_loop_step", step_counts[0]))
        shutil.rmtree(root)
        root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        out.update(_online_loop(device, root, maze_config))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def _online_loop(device, root, config=None) -> dict:
    """Two maze PPO rounds through `online_train_loop` at phase 3p's width:
    each round LMServer rollouts of the live policy (16 episodes cut to
    PPO_MAX_STEPS moves), the PPO data path, one epoch of B=32 steps; a
    round checkpoint after each round."""
    tok = ByteTokenizer()
    config = config or _maze_config(tok)
    L, pad = config.num_layers, tok.pad_token_id
    core = LMCore(config, device=device)
    server = LMServer(core, tok)
    sampling = SamplingConfig(max_new_tokens=MAZE_NEW, temperature=1.0, eos_token_id=10, pad_token_id=pad)
    policy = init_params(config, seed=50, device=device)
    init_policy = copy.deepcopy(policy).requires_grad_(False)
    value_head = LinearHead(LinearHeadConfig(config.hidden_size, 1), device=device, seed=51)
    state = PPOTrainState(TrainState(policy, adamw(1e-5)), TrainState(value_head, adamw(1e-4)))
    step = make_ppo_train_step(core, PPOConfig(gamma=0.99, lam=0.95), pad)
    env = build_maze_env(max_steps=PPO_MAX_STEPS)
    rounds = []

    def load_dataset(s, r):
        _reset_counts()
        t0 = time.perf_counter()
        pol = GenerationPolicy(lambda prompts, gen: server.generate_from_strs(s.policy.params, prompts, MAZE_LEN,
                                                                              sampling, gen),
                               torch.Generator(device=device).manual_seed(60 + r))
        games, _ = text_env_eval(env, pol, n_rollouts=16, seed_generator=iter(range(100 * r, 100 * r + 16)), bsize=16)
        chains = []
        for game in games:
            chain = None
            for tr in reversed(game):
                chain = TextTrajectoryChain(TextTrajectory((tr.pre_action_history[-1], tr.post_action_history[-1]),
                                                           (0.0, tr.reward), tr.done), chain)
            chains.append(TokenTrajectoryChain.from_text_trajectory_chain(chain, tok))
        fwd = make_ppo_forward_fn(core, init_policy, s.policy.params, s.value_head.params, pad)
        datas, _ = get_ppo_data_from_chains(fwd, tok, chains, TRAIN_B, MAZE_LEN, gamma=0.99, lam=0.95, kl_weight=0.01)
        _sync(device)
        rounds.append(dict(data_s=time.perf_counter() - t0, rollout_counts=_all_counts(), windows=len(datas)))
        return ArrayDataset(block_ppo_data(datas, BlockingStrategy(Padding.RIGHT, Truncation.RIGHT, MAZE_LEN), pad))

    def batch_prep(b):
        t = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in b.items()}
        return PPOBatch(t["input_ids"].long(), t["should_take_action"], t["old_logprobs"], t["old_values"],
                        t["old_advantages"], t["old_returns"])

    step_counts = []

    def step_fn(s, b, generator):
        _reset_counts()
        out = step(s, b)
        step_counts.append(_all_counts())
        return out

    t0 = time.perf_counter()
    state, ls = online_train_loop(state, step_fn, load_dataset,
                                  OnlineLoopConfig(n_rounds=2, epochs_per_round=1, train_bsize=TRAIN_B, log_every=None,
                                                   eval_every_rounds=None, save_every_rounds=1, save_at_end=False,
                                                   save_dir=root),
                                  batch_prep=batch_prep,
                                  module_getter=lambda s: {"policy": s.policy, "value_head": s.value_head})
    _sync(device)
    t_all = time.perf_counter() - t0
    check(ls.round == 2 and sorted(os.listdir(root)) == ["round_0", "round_1"], f"online loop: {os.listdir(root)}")
    for c in step_counts:
        check(c == _want(L, fwd=1, bwd=1), f"online loop PPO step: {_fmt_counts(c)}")
    n_bytes = _dir_bytes(os.path.join(root, "round_1"))
    restored = LinearHead(LinearHeadConfig(config.hidden_size, 1), device=device, seed=0)
    restore_module(os.path.join(root, "round_1"), "value_head", restored)
    check(torch.equal(restored.dense.weight, value_head.dense.weight), "online loop: round checkpoint value head")
    log(f"loops (3l) online maze PPO: 2 rounds in {t_all:.2f} s (rollout + data {[round(r['data_s'], 3) for r in rounds]} s, "
        f"{[r['windows'] for r in rounds]} windows), {len(step_counts)} steps ({_fmt_counts(step_counts[0])} each), "
        f"round checkpoint {n_bytes / 1e9:.3f} GB (policy + value head, params)")
    return {**_path_counts("online_loop_step", step_counts[0]), "online_loop_s": t_all}


def _gate_counts(gate, run) -> tuple:
    """Run a PPO gate with its launches counted and its LMServer calls and
    each round's PPO windows recorded; returns (result, counts, seconds,
    LMServer calls, windows per round)."""
    calls, forwards = [], []
    generate = gate.generate
    gate.generate = lambda *a, **kw: (calls.append(1), generate(*a, **kw))[1]
    ppo_data = gate.ppo_data

    def counted_ppo_data(state, init_policy, chains, kl_weight):
        blocked, mean_kl, n = ppo_data(state, init_policy, chains, kl_weight)
        forwards.append(n)
        return blocked, mean_kl, n

    gate.ppo_data = counted_ppo_data
    result, counts, s = _counted(run, gate, device=gate.device)
    return result, counts, s, len(calls), forwards


def phase_ppo_gates(device="cuda", extra=()) -> dict:
    """Phase 3w: the port's two PPO gates at their own width (d256 L4 H4)
    and a cut budget (TN_GATE_ARGS, MAZE_PPO_GATE_ARGS): launch counts
    exactly the budget's — per LMServer call L K1 and L·new K4, per BC and
    PPO step L each of K1/K2/K3, per PPO forward call 2L K1 — and every
    return inside its env's range (Text-Nav: a win rate in [0, 1]; the maze:
    −1 per move, episodes cut to MAZE_PPO_GATE_MOVES moves)."""
    out = {}
    for name, module, argv, lo in (("text_nav", text_nav_ppo_gate, TN_GATE_ARGS, 0.0),
                                   ("maze", maze_ppo_gate, MAZE_PPO_GATE_ARGS, -401.0)):
        args = module.parse_args(argv + list(extra) + ["--device", device])
        g = module.Gate(args)
        if name == "maze":
            g._env = build_maze_env(max_steps=MAZE_PPO_GATE_MOVES)  # the env `eval_env` serves
        L, bs = args.layers, args.bsize
        n_windows_bc = sum(len(c.to_list()) for c in g.bc_token_chains())
        result, counts, s, n_calls, windows = _gate_counts(g, module.run)
        bc_steps = -(-n_windows_bc // bs) * args.bc_epochs
        fwd_calls = sum(-(-n // bs) for n in windows)
        ppo_steps = sum(-(-n // bs) for n in windows) * args.epochs_per_round
        want = tuple(sum(x) for x in zip(_want(L, fwd=n_calls, dec=n_calls * g.MAX_NEW),
                                         _want(L, fwd=bc_steps + ppo_steps + 2 * fwd_calls, bwd=bc_steps + ppo_steps)))
        check(counts == want, f"PPO gate {name}: {_fmt_counts(counts)}, want {want}")
        returns = [result[k] for k in ("bc_return", "ppo_return", "bc_return_greedy", "ppo_return_greedy")]
        returns += [r["rollout_reward"] for r in result["kl_trace"]]
        check(all(lo <= r <= (1.0 if lo == 0.0 else 0.0) for r in returns), f"PPO gate {name}: returns {returns}")
        check(all(math.isfinite(r["mean_kl"]) for r in result["kl_trace"]), f"PPO gate {name}: {result['kl_trace']}")
        log(f"PPO gate (3w) {name} ({' '.join(argv)}): {s:.1f} s, {n_calls} LMServer calls, {bc_steps} BC steps, "
            f"{fwd_calls} PPO forward calls, {ppo_steps} PPO steps, {_fmt_counts(counts)}; result "
            f"{ {k: v for k, v in result.items() if k != 'model'} }")
        out.update(_path_counts(f"ppo_gate_{name}", counts))
        out[f"ppo_gate_{name}_s"] = s
    return out


# ---------------- slice 8: the Markov actors, online Markov ILQL, the chess gate ----------------

MARKOV_TURNS = port_bench.MARKOV_TURNS  # bench.py::bench_actor_markov's turns
MARKOV_PROFILED_STEPS = 2  # 3u: train steps under the profiler
MARKOV_VOCAB = 512
MAZE_REWARDS, CHESS_REWARDS = {0.0, -1.0, -4.0}, {1.0, 0.0, -1.0}
CHESS_GATE_ARGS = ["--train-pool", "64", "--eval-pool", "32", "--bc-batches", "20", "--ilql-batches", "20",
                   "--eval-every", "10", "--obs", "grid"]


def markov_config():
    """GPT-2-small (d768 L12 H12) over a 512-token vocab (a multiple of 128)."""
    return port_bench.actor_config(MARKOV_VOCAB)


def _frame_fens(obs: torch.Tensor) -> list:
    """The FEN spelled in each FEN observation frame (chars at even slots)."""
    return [bytes(row).decode().rstrip(" ") for row in obs[:, 0:-1:2].cpu().numpy().astype(np.uint8)]


def _check_markov_rollout(out, name: str, env, batch: int, n_turns: int) -> None:
    """Shapes; turn liveness that never comes back; rewards in the env's
    set; illegal flags only on live turns; every chess frame's FEN valid
    for the port's engine binding."""
    check(out.obs_tokens.shape == (batch, n_turns, env.OBS_LEN) and out.act_tokens.shape == (batch, n_turns, env.ACT_LEN),
          f"markov {name}: shapes {tuple(out.obs_tokens.shape)} {tuple(out.act_tokens.shape)}")
    live = out.turn_live
    check(bool(live[:, 0].all()) and bool((live[:, :-1] >= live[:, 1:]).all()), f"markov {name}: a turn came back to life")
    rewards = set(out.turn_reward[live].unique().tolist())
    check(rewards <= (MAZE_REWARDS if name == "maze" else CHESS_REWARDS), f"markov {name}: rewards {rewards}")
    check(bool((out.turn_reward[~live] == 0).all()) and not bool((out.turn_illegal & ~live).any()),
          f"markov {name}: a dead turn carries a reward or an illegal flag")
    if name == "chess":
        fens = _frame_fens(torch.cat([out.obs_tokens.reshape(-1, env.OBS_LEN), out.final_obs]))
        bad = [f for f in fens if not chess_engine.validate_fen(f)]
        check(not bad, f"markov chess: {len(bad)} of {len(fens)} observation FENs fail the engine: {bad[:3]}")


def phase_online_markov(device="cuda", config=None) -> dict:
    """Phase 3u: `online_ilql_markov` on chess (FEN, 8 moves, 8 turns) at
    full width: GPT-2-small with f32 parameters and bf16 activations, twin
    MLP Q heads and a V head, a separate target base, a frozen π_β (two
    trunks), OnlineDeviceConfig(n_rounds=2, rollout_batch=256,
    train_bsize=64). Per round: the rollout's launches (8 x 2L K1, 8 x 8 x
    2L K4; the two-trunk value-guided chess rollout at B=256), each step's (3L K1: the trained, target and next-window
    forwards; L K2/K3), a finite loss, base weights that move, rollout and
    train wall time; then a rollout and two of a round's steps profiled."""
    config = config or markov_config()
    L = config.num_layers
    core = LMCore(config, device=device)
    env = port_bench.markov_envs(device)["chess"]
    base, q1, q2, v = _train_modules(config, device)
    pi_beta = init_params(config, seed=9, device=device)
    ilql_config = ILQLConfig(beta=4.0)
    state = init_ilql_state(base, q1, q2, v, adamw(1e-4), adamw(1e-3), ilql_config)
    ocfg = OnlineDeviceConfig(n_rounds=2, rollout_batch=256, train_bsize=64)
    gen = torch.Generator(device=device).manual_seed(11)
    record: list = []
    t0 = time.perf_counter()
    with traced_online_round(record, "rollout_markov"):
        state, history = online_ilql_markov(core, state, env, MARKOV_TURNS, ilql_config, ocfg, pi_beta=pi_beta,
                                            generator=gen)
    total = time.perf_counter() - t0
    want_roll = _want(L, fwd=2 * MARKOV_TURNS, dec=2 * MARKOV_TURNS * env.ACT_LEN)
    want_step = _want(L, fwd=3, bwd=1)
    rolls = [i for i, r in enumerate(record) if r["kind"] == "rollout"]
    check(len(rolls) == ocfg.n_rounds == len(history), f"online markov: {len(rolls)} rollouts, {len(history)} rounds")
    out = {}
    for r, i in enumerate(rolls):
        roll = record[i]
        steps = record[i + 1: rolls[r + 1] if r + 1 < len(rolls) else len(record)]
        live = roll["out"].turn_live
        n_steps = max(1, min(live.numel() // ocfg.train_bsize, -(-int(live.sum()) // ocfg.train_bsize)))
        check(len(steps) == n_steps and all(st["kind"] == "step" for st in steps),
              f"online markov round {r}: {len(steps)} steps, want {n_steps}")
        check(roll["counts"] == want_roll, f"online markov round {r} rollout: {_fmt_counts(roll['counts'])}, want {want_roll}")
        _check_markov_rollout(roll["out"], "chess", env, ocfg.rollout_batch, MARKOV_TURNS)
        for j, st in enumerate(steps):
            check(st["counts"] == want_step, f"online markov round {r} step {j}: {_fmt_counts(st['counts'])}, want {want_step}")
            check(math.isfinite(st["loss"]), f"online markov round {r} step {j}: loss {st['loss']}")
        if r:
            check(not torch.equal(record[rolls[r - 1]]["weights"], roll["weights"]),
                  f"online markov round {r}: the trunk's weights did not move since round {r - 1}")
        m = history[r]
        check(math.isfinite(m["loss"]), f"online markov round {r}: loss {m['loss']}")
        train_s = sum(st["s"] for st in steps)
        log(f"online markov round (3u) {r}: rollout B={ocfg.rollout_batch} {roll['s']:.3f} s ({_fmt_counts(roll['counts'])}), "
            f"train {train_s:.3f} s for {len(steps)} steps B={ocfg.train_bsize} T={env.OBS_LEN + env.ACT_LEN} "
            f"(per step {_fmt_counts(steps[0]['counts'])}); return {m['mean_episode_reward']:.3f} turns "
            f"{m['mean_turns']:.2f} illegal {m['illegal_rate']:.3f} loss {m['loss']:.4f}")
        out = {**_path_counts("online_markov_round", tuple(sum(c) for c in zip(roll["counts"], *(st["counts"] for st in steps)))),
               **_path_counts("online_markov_step", steps[0]["counts"]), **_path_counts("markov_guided", roll["counts"])}
    log(f"online markov ILQL (3u): {ocfg.n_rounds} rounds in {total:.3f} s")
    if torch.device(device).type == "cuda":
        step_fn, carry0 = actor.make_value_guided_step_fn(core, ocfg.rollout_batch, two_trunks=True, twin_q=True,
                                                          beta=ilql_config.beta, total_len=env.OBS_LEN + env.ACT_LEN)
        policy = {"pi_beta": pi_beta, "base": state.base.params, "q1": state.q1_head.params, "q2": state.q2_head.params}

        def rollout():
            return actor.rollout_markov(env, MARKOV_TURNS, step_fn, policy, carry0, env.reset(ocfg.rollout_batch, gen),
                                        generator=gen)

        profile_run("online markov rollout", rollout, record[rolls[-1]]["s"])
        batch = markov_rollout_to_ilql_batch(record[rolls[-1]]["out"])
        step = make_ilql_train_step(core, ilql_config, ocfg.pad_token_id)
        # MARKOV_PROFILED_STEPS of the round's steps: the profiler's own cost grows with the
        # launches it records (~2,300 per step)
        mb, steps = ocfg.train_bsize, record[rolls[-1] + 1: rolls[-1] + 1 + MARKOV_PROFILED_STEPS]

        def train_steps():
            for i in range(len(steps)):
                step(state, ILQLBatch(*(x[i * mb: (i + 1) * mb] for x in batch)))

        profile_run(f"online markov train steps ({len(steps)} of a round)", train_steps, sum(st["s"] for st in steps))
    return out


def phase_chess_gate(device="cuda", extra=()) -> dict:
    """Phase 3h: the port's chess gate at its own width (d256 L4 H4, byte
    vocab, --obs grid) and a cut budget (CHESS_GATE_ARGS): launch counts
    exactly the budget's — per BC step L K1/K2/K3, per ILQL step L each (no
    separate target base, no next window), per reranker score call L K1,
    the guided greedy turn 2L K1 and 2L x ACT_LEN K4, the legality-masked
    decode the same — and every rate finite in [0, 1]."""
    args = chess_ilql_gate.parse_args(CHESS_GATE_ARGS + list(extra) + ["--device", device])
    L = args.layers
    g = chess_ilql_gate.Gate(args)
    n_moves = []
    legal_moves = g.legal_moves
    g.legal_moves = lambda pool: (lambda rows: (n_moves.append(len(rows)), rows)[1])(legal_moves(pool))
    result, counts, s = _counted(chess_ilql_gate.run, g, device=device)
    score_calls = sum(-(-n // chess_ilql_gate.SCORE_CHUNK) for n in n_moves[:-1])  # the last call: the masked decode
    A = g.env.ACT_LEN
    want = tuple(sum(x) for x in zip(_want(L, fwd=args.bc_batches + args.ilql_batches, bwd=args.bc_batches + args.ilql_batches),
                                     _want(L, fwd=score_calls), _want(L, fwd=2 + 2, dec=2 * A + 2 * A)))
    check(len(n_moves) == args.ilql_batches // args.eval_every + 3, f"chess gate: {len(n_moves)} legal-move sets")
    check(counts == want, f"chess gate: {_fmt_counts(counts)}, want {want}")
    rates = [v for k, v in result.items() if k != "curve"] + [c["rerank"] for c in result["curve"]]
    check(all(math.isfinite(r) and 0.0 <= r <= 1.0 for r in rates), f"chess gate: rates {result}")
    log(f"chess gate (3h) ({' '.join(CHESS_GATE_ARGS + list(extra))}): {s:.1f} s, {score_calls} score calls over "
        f"{n_moves} candidates, {_fmt_counts(counts)}; result {result}")
    out = _path_counts("chess_gate", counts)
    out.update(chess_gate_s=s, chess_gate_result=result)
    return out


# ---------------- slice 9: the LM-oracle dialog stack ----------------

DIALOG_B, DIALOG_TURNS = 64, 2  # 3d: episodes, env turns per oracle
DIALOG_MAX_LEN, DIALOG_NEW = 768, 48  # the dialog gates' policy prompts and new tokens
ORACLE_INPUT, ORACLE_NEW = 256, 8  # lm_oracle.build_lm_twenty_questions_env's oracle calls
T5_CHECK_LAYERS = 2  # 3d's card-vs-CPU T5 check: flan-t5-xl widths, 2 + 2 layers
# card (bf16) vs CPU (f32) T5 outputs, as the RMS of the difference over
# the RMS of the CPU output. Both devices round to bf16 (8 significant
# bits) at the same points, but with random weights T5's unscaled scores
# have a std of about sqrt(d_kv) = 8, so the softmax is near one-hot and
# amplifies the rounding by an amount no per-op count predicts (the first
# run's logits: 3.9% against a 3% bound derived from 2^-9 per rounding).
# So the yardstick is measured in the same run, on the same weights and
# inputs: the same bf16 arithmetic on the CPU against its f32; the card
# must come within T5_RMS_FACTOR times that
T5_RMS_FACTOR = 2.0
# (name, dtype, batch, heads, Dh, prompt, new tokens): the dialog paths'
# K1 prefill (left-padded, a view of prompt + new cache slots) and K4 at
# the first, a middle and the last new slot. The gates' decoder oracle
# (d128 H4: 256 + 8; the fidelity probe's B=100 and an env turn's 16), the
# Car-Dealer LM buyer (d192 H4: 768 + 64, B=1), the gates' policies (d256
# H4: 768 + 48; greedy B=16, the reranker's 16 x 8 = 128 proposals), all
# f32 as the gates run; 3d's asker (GPT-2-small, B=64, 768 + 48) and its
# decoder oracle (256 + 8), bf16; and the tensor-core variants at Dh 32
# and 48 in bf16
DIALOG_SERVE_SHAPES = (
    ("oracle", torch.float32, 100, 4, 32, ORACLE_INPUT, ORACLE_NEW),
    ("oracle", torch.float32, 16, 4, 32, ORACLE_INPUT, ORACLE_NEW),
    ("buyer", torch.float32, 1, 4, 48, 768, 64),
    ("policy", torch.float32, 16, 4, 64, DIALOG_MAX_LEN, DIALOG_NEW),
    ("policy rerank", torch.float32, 128, 4, 64, DIALOG_MAX_LEN, DIALOG_NEW),
    ("3d asker", torch.bfloat16, DIALOG_B, H, DH, DIALOG_MAX_LEN, DIALOG_NEW),
    ("3d decoder oracle", torch.bfloat16, DIALOG_B, H, DH, ORACLE_INPUT, ORACLE_NEW),
    ("Dh 32 (tensor cores)", torch.bfloat16, 16, 4, 32, ORACLE_INPUT, ORACLE_NEW),
    ("Dh 48 (tensor cores)", torch.bfloat16, 4, 4, 48, 768, 64),
)
# (name, dtype, batch, heads, Dh, T, backward too): the train windows — the
# oracle's BC (256), the buyer's (512), the 20Q policies' BC / ILQL (768)
# and the Car-Dealer's BC / ILQL / MC (448), B=16, right-padded, f32; the
# score calls (B = 16 x 8 = 128 proposals, 768 and 448), forward only; the
# tensor-core backward at Dh 32 and 48 in bf16
DIALOG_TRAIN_SHAPES = (
    ("oracle BC", torch.float32, 16, 4, 32, 256, True),
    ("buyer BC", torch.float32, 16, 4, 48, 512, True),
    ("20Q policy", torch.float32, 16, 4, 64, 768, True),
    ("Car-Dealer policy", torch.float32, 16, 4, 64, 448, True),
    ("20Q score call", torch.float32, 128, 4, 64, 768, False),
    ("Car-Dealer score call", torch.float32, 128, 4, 64, 448, False),
    ("Dh 32 (tensor cores)", torch.bfloat16, 16, 4, 32, 256, True),
    ("Dh 48 (tensor cores)", torch.bfloat16, 16, 4, 48, 512, True),
)
DIALOG_GATE_ARGS = {  # 3e: the port's dialog gates at a cut budget (their own widths)
    "car_dealer": ["--behavior-episodes", "32", "--bc-epochs", "1", "--ilql-epochs", "1", "--mc-epochs", "1",
                   "--eval-rollouts", "2", "--eval-bsize", "2", "--buyer-episodes", "32", "--buyer-epochs", "1"],
    "dialog_ilql": ["--behavior-episodes", "16", "--bc-epochs", "1", "--ilql-epochs", "1", "--eval-rollouts", "2",
                    "--eval-bsize", "2", "--oracle-episodes", "8", "--oracle-epochs", "1"],
    "twenty_questions": ["--behavior-episodes", "16", "--p-good", "-1", "--bc-epochs", "1", "--eval-rollouts", "2",
                         "--eval-bsize", "2", "--oracle-episodes", "8", "--oracle-epochs", "1"],
}


def _dialog_cache(b, h, dh, t_max, prompt, dtype, gen):
    """q (a view into a fused [b, prompt, 3, h, dh] projection), a
    [b, h, t_max, dh] K/V cache and a [b, t_max] left-pad bias (each row's
    padding shorter than the prompt)."""
    q = torch.randn(b, prompt, 3, h, dh, device="cuda", generator=gen).to(dtype)[:, :, 0].transpose(1, 2)
    k = torch.randn(b, h, t_max, dh, device="cuda", generator=gen).to(dtype)
    v = torch.randn(b, h, t_max, dh, device="cuda", generator=gen).to(dtype)
    n_pad = torch.randint(0, prompt, (b,), device="cuda", generator=gen)
    bias = torch.where(torch.arange(t_max, device="cuda")[None, :] >= n_pad[:, None], 0.0, _NEG_BIG).float()
    return q, k, v, bias


F32_REPS = 10  # timed launches per f32 dialog shape


def _f32_row(kernel: str, shape: str, ms: float, bound: tuple, plain_ms: float, library_ms: float) -> dict:
    row = dict(kernel=kernel, shape=shape, ms=ms, bound_ms=bound[0], bound_by=bound[1], plain_ms=plain_ms,
               library_ms=library_ms)
    log(f"time f32 {kernel} dialog {shape}: kernel_ms={ms:.4f} bound_ms={bound[0]:.4f} ({bound[1]}; f32 peak "
        f"{PEAK_FLOPS[torch.float32] / 1e12:.0f} TF/s outside the tensor cores) plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} (SDPA, f32, TF32 off)")
    return row


def _time_f32_serving(name, q, k, v, bias, prompt: int, index: int) -> list:
    """The CUDA-core K1 on a dialog prefill and K4 at one decode slot, f32:
    kernel, bound (bytes with the bias), plain and SDPA ms."""
    dtype, (b, h, _, dh) = torch.float32, q.shape
    scale, sdpa = dh**-0.5, torch.nn.functional.scaled_dot_product_attention
    kp, vp, bp = k[:, :, :prompt], v[:, :, :prompt], bias[:, :prompt]
    mask = sdpa_mask(bp, prompt, prompt, b)
    n_bytes, flops = flash_work(b, h, dh, prompt, prompt, dtype)
    rows = [_f32_row("flash_fwd", f"{name} B={b} H={h} Dh={dh} prefill {prompt}",
                     cuda_ms(lambda: flash_fwd(q, kp, vp, bp, True, scale), F32_REPS),
                     bound_ms(n_bytes + 4 * b * prompt, flops, dtype),
                     cuda_ms(lambda: _plain_attention(q, kp, vp, bp, True, scale), F32_REPS),
                     cuda_ms(lambda: sdpa(q, kp, vp, attn_mask=mask, scale=scale), F32_REPS))]
    q1 = q[:, :, -1:].contiguous()
    n = index + 1
    kn, vn, dmask = k[:, :, :n], v[:, :, :n], (bias[:, :n] == 0)[:, None, None, :]
    n_bytes, flops = decode_work(b, h, dh, n, dtype)
    rows.append(_f32_row("decode_attn", f"{name} B={b} H={h} Dh={dh} index {index}",
                         cuda_ms(lambda: decode_attention(q1, k, v, index, bias, scale), F32_REPS),
                         bound_ms(n_bytes + 4 * b * n, flops, dtype),
                         cuda_ms(lambda: _plain_decode_attention(q1, k, v, index, bias, scale), F32_REPS),
                         cuda_ms(lambda: sdpa(q1, kn, vn, attn_mask=dmask, scale=scale), F32_REPS)))
    return rows


def _time_f32_train(name, args) -> list:
    """The CUDA-core K1-K3 on a right-padded f32 dialog train window:
    kernel, bound, plain ms; SDPA's forward, and its backward for the pair."""
    q, k, v, bias, lse, delta, dout = args
    dtype, (b, h, T, dh) = torch.float32, q.shape
    scale, sdpa = dh**-0.5, torch.nn.functional.scaled_dot_product_attention
    shape = f"{name} B={b} H={h} Dh={dh} T={T}"
    mask = sdpa_mask(bias, T, T, b)
    n_bytes, flops = flash_work(b, h, dh, T, T, dtype)
    rows = [_f32_row("flash_fwd", shape, cuda_ms(lambda: flash_fwd(q, k, v, bias, True, scale), F32_REPS),
                     bound_ms(n_bytes + 4 * b * T, flops, dtype),
                     cuda_ms(lambda: _plain_attention(q, k, v, bias, True, scale), F32_REPS),
                     cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=scale), F32_REPS))]
    library = sdpa_bwd_ms(q, k, v, bias, dout, scale, causal_only=False, reps=F32_REPS)
    for kernel, kind, fn, plain in (("flash_bwd_dq", "dq", flash_bwd_dq, _plain_bwd_dq),
                                    ("flash_bwd_dkv", "dkv", flash_bwd_dkv, _plain_bwd_dkv)):
        rows.append(_f32_row(kernel, shape, cuda_ms(lambda: fn(*args, True, scale), F32_REPS),
                             bound_ms(*bwd_work(b, h, dh, T, T, dtype, kind, True), dtype),
                             cuda_ms(lambda: plain(*args, True, scale), F32_REPS), library))
    return rows


def _check_dialog_shapes(gen, errs: dict) -> list:
    """K1-K4 against their plain versions at the dialog paths' shapes
    (DIALOG_SERVE_SHAPES, DIALOG_TRAIN_SHAPES), in the dtypes the paths run:
    the gates' f32 (CUDA-core K1-K3) at Dh 32, 48 and 64, caches of 264,
    816 and 832 slots, 768-token prefills and train windows; 3d's bf16.
    Returns the f32 shapes' timings (kernel, bound, plain and SDPA ms per
    launch; `_time_f32_serving`, `_time_f32_train`)."""
    f32_rows = []
    for name, dtype, b, h, dh, prompt, new in DIALOG_SERVE_SHAPES:
        W = prompt + new
        q, k, v, bias = _dialog_cache(b, h, dh, W, prompt, dtype, gen)
        err, lse_err = _check_fwd(q, k[:, :, :prompt], v[:, :, :prompt], bias[:, :prompt], bias[:, :prompt] == 0,
                                  dtype, f"dialog {name} B={b} H={h} Dh={dh} prefill {prompt}")
        errs["flash_fwd"] = max(errs["flash_fwd"], err)
        dec_err = 0.0
        for index in (prompt, prompt + new // 2, W - 1):
            q1 = torch.randn(b, h, 1, dh, device="cuda", generator=gen).to(dtype)
            dec_err = max(dec_err, _check_decode(q1, k, v, index, bias, dtype, f"dialog {name} B={b} Dh={dh} "
                                                                               f"T_max={W} index={index}"))
        errs["decode_attn"] = max(errs["decode_attn"], dec_err)
        log(f"check dialog {name} B={b} H={h} Dh={dh} {str(dtype)[6:]}: flash_fwd prefill {prompt} (view of a {W} "
            f"cache, left-padded) max_abs_err={err:.3e} lse_err={lse_err:.3e}; decode_attn index {prompt}, "
            f"{prompt + new // 2}, {W - 1} max_abs_err={dec_err:.3e}")
        if dtype == torch.float32:
            f32_rows += _time_f32_serving(name, q, k, v, bias, prompt, prompt + new // 2)
    for name, dtype, b, h, dh, T, backward in DIALOG_TRAIN_SHAPES:
        args, rows, _ = _bwd_inputs(T, T, dtype, "right", gen, b, h, dh)
        fwd_err, _ = _check_fwd(*args[:4], rows, dtype, f"dialog {name} B={b} Dh={dh} T={T}")
        errs["flash_fwd"] = max(errs["flash_fwd"], fwd_err)
        line = [f"flash_fwd_max_abs_err={fwd_err:.3e}"]
        if backward:
            scale = 1.0 / dh**0.5
            tc0 = (flash_bwd_dq.tc_launches, flash_bwd_dkv.tc_launches)
            got = (flash_bwd_dq(*args, True, scale), *flash_bwd_dkv(*args, True, scale))
            n_tc = (flash_bwd_dq.tc_launches - tc0[0], flash_bwd_dkv.tc_launches - tc0[1])
            want_tc = int(_variant(dtype, dh, "flash_bwd_dq") == "tc")
            check(n_tc == (want_tc, want_tc), f"flash_bwd dialog {name}: tensor-core launches {n_tc}, want {want_tc}")
            ref = (_plain_bwd_dq(*args, True, scale), *_plain_bwd_dkv(*args, True, scale))
            torch.cuda.synchronize()
            for g_name, a, r in zip(("dq", "dk", "dv"), got, ref):
                err = (a.float() - r.float()).abs().max().item()
                over = ((a.float() - r.float()).abs() - GRAD_TOL[dtype][1] * r.float().abs()).max().item()
                check(over <= GRAD_TOL[dtype][0], f"flash_bwd {g_name} dialog {name} B={b} Dh={dh} T={T}: max abs "
                                                  f"err {err} over tolerance {GRAD_TOL[dtype]}")
                kernel = "flash_bwd_dq" if g_name == "dq" else "flash_bwd_dkv"
                errs[kernel] = max(errs.get(kernel, 0.0), err)
                line.append(f"{g_name}_max_abs_err={err:.3e}")
        log(f"check dialog {name} B={b} H={h} Dh={dh} T={T} right-padded {str(dtype)[6:]}: " + " ".join(line)
            + f" (atol, rtol {TOL[dtype]} / {GRAD_TOL[dtype]})")
        if dtype == torch.float32 and backward:
            f32_rows += _time_f32_train(name, args)
    return f32_rows


def dialog_tokenizer():
    """The 20Q task BPE of the dialog gates (vocab target 2048)."""
    return train_bpe_for_task("twenty_questions", vocab_size=2048, n_episodes=200, seed=0)


DIALOG_GATE_TURNS = 3  # 3e: 20Q episodes and Car-Dealer LM-buyer episodes cut to 3 turns
DIALOG_GATE_BALANCED_QA = 64  # 3e: the balanced oracle QA (~1,260 windows) cut to its first 64


@contextlib.contextmanager
def _cut_dialog_budget():
    """3e's cuts, by patching what the gates call: the 20Q envs (scripted
    and LM oracle) end after DIALOG_GATE_TURNS questions and the LM-buyer
    Car-Dealer env after DIALOG_GATE_TURNS turns (the gates' envs allow 20
    and 50), and the balanced QA the 20Q oracles train on keeps its first
    DIALOG_GATE_BALANCED_QA windows."""
    from lmrl_gym_torch.cli import tasks

    turns = lambda build: lambda *a, **kw: build(*a, **{**kw, "max_conversation_length": DIALOG_GATE_TURNS})  # noqa: E731
    patches = [(tasks, "build_twenty_questions_env", turns), (lm_oracle, "build_lm_twenty_questions_env", turns),
               (lm_oracle, "build_lm_car_dealer_env", turns),
               (lm_oracle, "collect_twenty_questions_qa_balanced",
                lambda collect: lambda *a, **kw: collect(*a, **kw)[:DIALOG_GATE_BALANCED_QA])]
    saved = [getattr(obj, name) for obj, name, _ in patches]
    for obj, name, cut in patches:
        setattr(obj, name, cut(getattr(obj, name)))
    try:
        yield
    finally:
        for (obj, name, _), fn in zip(patches, saved):
            setattr(obj, name, fn)


def _want_f32(L: int, fwd: int = 0, dec: int = 0, bwd: int = 0) -> tuple:
    """`_want` for f32 launches (the CUDA-core K1-K3: no tensor-core share)."""
    return (fwd * L, 0, dec * L, bwd * L, 0, bwd * L, 0)


def _t5_card_vs_cpu(config, device) -> dict:
    """The T5 at `config`'s widths with T5_CHECK_LAYERS + T5_CHECK_LAYERS
    layers, weights from one seed: bf16 on the card and bf16 on the CPU,
    each against f32 on the CPU, on the encoder output and the first
    decode step's logits (real vocab), in relative RMS; the card within
    T5_RMS_FACTOR times the CPU's bf16 error."""
    cfg = config.replace(num_layers=T5_CHECK_LAYERS, num_decoder_layers=T5_CHECK_LAYERS, dtype="float32")
    bf16_cfg = cfg.replace(dtype="bfloat16")
    ref = EncoderDecoder(cfg, device=device, seed=3).to("cpu")  # every draw on `device`: seconds faster
    gen = torch.Generator().manual_seed(4)
    ids = torch.randint(1, cfg.vocab_size, (2, 32), generator=gen)
    mask = (torch.arange(32)[None, :] < torch.tensor([32, 9])[:, None]).to(torch.int32)
    ids = ids * mask  # right-padded with pad_token_id 0
    B = ids.shape[0]

    def run(dev, c, dtype):
        model = ref if c is cfg else EncoderDecoder(c, device=device, dtype=dtype, seed=3).to(dev)
        if model is not ref:
            model.load_state_dict(ref.state_dict())
        fn, cache = EncDecCore(c, device=dev).make_seq2seq_logits_fn(model, ids.to(dev), mask.to(dev), 2)
        with torch.no_grad():
            enc = model.encode(ids.to(dev), mask.to(dev))
            logits, _ = fn(torch.zeros((B, 1), dtype=torch.int64, device=dev),
                           torch.ones((B, 1), dtype=torch.int32, device=dev), cache)
        return enc.float().cpu()[mask.bool()], logits[:, 0, :cfg.vocab_size].float().cpu()

    want = run("cpu", cfg, torch.float32)
    cpu_bf16, card = run("cpu", bf16_cfg, torch.bfloat16), run(device, bf16_cfg, torch.bfloat16)
    rel = lambda a, r: ((a - r).pow(2).mean().sqrt() / r.pow(2).mean().sqrt()).item()  # noqa: E731
    res = {}
    for i, name in enumerate(("encoder", "logits")):
        err, yard = rel(card[i], want[i]), rel(cpu_bf16[i], want[i])
        res[name], res[f"{name}_cpu_bf16"] = err, yard
        check(math.isfinite(err) and err <= T5_RMS_FACTOR * yard,
              f"T5 card vs CPU {name}: relative RMS error {err} over {T5_RMS_FACTOR} x the CPU's bf16 error {yard}")
    return res


def _t5_breakdown(run) -> dict:
    """CUDA-event times of the T5's plain attention cores (scores, bias,
    mask, softmax, PV: `T5Attention._attend`) and of its f32 `lm_head`
    (`EncoderDecoder._logits`) inside `run`, in ms, with run's wall ms."""
    events = {"t5 attention core": [], "t5 f32 lm_head": []}
    saved = (T5Attention._attend, EncoderDecoder._logits)

    def timed(label, fn):
        def wrapper(*a, **kw):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **kw)
            e.record()
            events[label].append((s, e))
            return out
        return wrapper

    T5Attention._attend = timed("t5 attention core", saved[0])
    EncoderDecoder._logits = timed("t5 f32 lm_head", saved[1])
    try:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        T5Attention._attend, EncoderDecoder._logits = saved
    out = {label: sum(s.elapsed_time(e) for s, e in ev) for label, ev in events.items()}
    out["wall_ms"] = wall
    out["calls"] = {label: len(ev) for label, ev in events.items()}
    return out


def phase_dialog(device="cuda", asker_config=None, t5_config=None, decoder_oracle_config=None) -> dict:
    """Phase 3d: the dialog stack at full width — the reference's own 20Q
    configuration, a GPT-2 asker against a flan-t5-xl oracle, then the same
    turns against the gates' decoder-oracle architecture at GPT-2-small
    width — in `BatchedTwentyQuestionsEnv`, DIALOG_B = 64 episodes,
    DIALOG_TURNS = 2 env turns per oracle. The asker: GPT-2-small (d768 L12
    H12) over the 20Q task BPE, bf16 weights from a seed, sampled through
    `GenerationPolicy` over `LMServer` (prompts to 768 tokens, 48 new). The
    T5: flan_t5_xl()'s widths (d2048, d_kv 64, d_ff 5120, 24 + 24 layers, 32
    heads, gated-gelu, untied; vocab the task BPE's, as train_t5_oracle_lm
    sets it), bf16 weights from a seed, served by `Seq2SeqServer` (256-token
    right-padded encoder inputs, 8 new tokens, greedy). Per turn: the
    asker's launches (L K1 + 48·L K4), the oracle's (T5: none; decoder:
    L K1 + 8·L K4), every answer 'Yes.' or 'No.', every live history one
    question and one answer longer; the median turn wall time split between
    asker and oracle; one more T5 turn profiled by device category, with
    the T5's attention cores and f32 lm_head timed on their own; and the T5 at
    2 + 2 layers, card against CPU (T5_RMS_FACTOR)."""
    tok = dialog_tokenizer()
    on_card = torch.device(device).type == "cuda"
    dtype = torch.bfloat16 if on_card else torch.float32
    asker_config = asker_config or gpt2_small().replace(vocab_size=tok.vocab_size, pad_vocab_to_multiple=128,
                                                        embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)
    t5_config = t5_config or flan_t5_xl().replace(vocab_size=tok.vocab_size, dropout_rate=0.0)
    decoder_oracle_config = decoder_oracle_config or asker_config
    t0 = time.perf_counter()
    asker = init_params(asker_config, seed=0, device=device, dtype=dtype)
    asker_server = LMServer(LMCore(asker_config, device=device), tok)
    sampling = SamplingConfig(max_new_tokens=DIALOG_NEW, greedy=False, temperature=1.0,
                              eos_token_id=tok.newline_token_id, pad_token_id=tok.pad_token_id)
    policy = GenerationPolicy(
        generate_batch=lambda prompts, g: asker_server.generate_from_strs(asker, prompts, DIALOG_MAX_LEN, sampling, g),
        generator=torch.Generator(device=device).manual_seed(5))
    t5 = EncoderDecoder(t5_config.replace(dtype="bfloat16" if on_card else "float32"), device=device, dtype=dtype,
                        seed=1)
    n_t5 = sum(p.numel() for p in t5.parameters())
    oracles = {
        "t5": (EncDecCore(t5.config, device=device), t5, 0),
        "decoder": (LMCore(decoder_oracle_config, device=device),
                    init_params(decoder_oracle_config, seed=2, device=device, dtype=dtype),
                    decoder_oracle_config.num_layers),
    }
    _sync(device)
    log(f"dialog setup (3d): BPE vocab {tok.vocab_size}; asker d{asker_config.hidden_size} L{asker_config.num_layers}; "
        f"T5 d{t5_config.d_model} L{t5_config.num_layers}+{t5_config.n_dec_layers} H{t5_config.num_heads} "
        f"{n_t5 / 1e9:.3f}B parameters ({n_t5 * torch.finfo(dtype).bits / 8e9:.2f} GB); "
        f"{time.perf_counter() - t0:.2f} s")
    La = asker_config.num_layers
    want_asker = _want(La, fwd=1, dec=DIALOG_NEW) if on_card else _want_f32(La, fwd=1, dec=DIALOG_NEW)
    out = {}
    answers = {"Yes.\n", "No.\n"}
    for name, (core, params, Lo) in oracles.items():
        env = build_lm_twenty_questions_env(core, tok, params, batched=True)
        histories = env.reset(list(range(DIALOG_B)))
        done = [False] * DIALOG_B
        t_ask, t_ora = [], []
        for turn in range(DIALOG_TURNS):
            acted, c_ask, s_ask = _counted(policy.act, histories, done, device=device)
            check(c_ask == want_asker, f"dialog {name} turn {turn} asker: {_fmt_counts(c_ask)}, want {want_asker}")
            results, c_ora, s_ora = _counted(env.step, acted, done, device=device)
            want_ora = (_want(Lo, fwd=1, dec=ORACLE_NEW) if on_card else _want_f32(Lo, fwd=1, dec=ORACLE_NEW))
            check(c_ora == want_ora, f"dialog {name} turn {turn} oracle: {_fmt_counts(c_ora)}, want {want_ora}")
            n_live = 0
            for i, (h, a, r) in enumerate(zip(histories, acted, results)):
                if done[i]:
                    check(a is None and r is None, f"dialog {name} turn {turn}: done slot {i} came back")
                    continue
                n_live += 1
                new_h, reward, d = r
                check(len(a) == len(h) + 1 and a[:-1] == h and a[-1].is_action, f"dialog {name}: slot {i} question")
                check(len(new_h) == len(h) + 2 and new_h[:-1] == a and new_h[-1].text in answers
                      and not new_h[-1].is_action, f"dialog {name}: slot {i} answer {new_h[-1].text!r}")
                check(reward in (-1.0, 0.0), f"dialog {name}: slot {i} reward {reward}")
                histories[i], done[i] = new_h, d
            t_ask.append(s_ask)
            t_ora.append(s_ora)
            n_yes = sum(h[-1].text == "Yes.\n" for h in histories)
            log(f"dialog (3d) {name} oracle turn {turn}: {n_live} live episodes; asker {s_ask:.3f} s "
                f"({_fmt_counts(c_ask)}), oracle {s_ora:.3f} s ({_fmt_counts(c_ora)}); {n_yes} 'Yes.' answers")
        med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
        log(f"dialog (3d) {name} oracle: median turn {med([a + b for a, b in zip(t_ask, t_ora)]):.3f} s (asker "
            f"{med(t_ask):.3f} s, oracle {med(t_ora):.3f} s) over {DIALOG_TURNS} turns at B={DIALOG_B}; longest prompt "
            f"{max(len(tok.encode(text_history_to_str(h))) for h in histories)} tokens")
        out.update(_path_counts("dialog_asker_turn", c_ask))
        if name == "decoder":
            out.update(_path_counts("dialog_oracle_turn", c_ora))
        out[f"dialog_{name}_turn_s"] = med([a + b for a, b in zip(t_ask, t_ora)])
        if on_card and name == "t5":  # one profiled turn: the reference's configuration
            live = [i for i, d in enumerate(done) if not d]

            def turn():
                acted = policy.act(histories, done)
                env.step(acted, done)

            profile_run(f"dialog turn, {name} oracle (asker + oracle)", turn, med(t_ask) + med(t_ora))
            acted = policy.act(histories, done)
            br = _t5_breakdown(lambda: env.step(acted, done))
            log(f"dialog (3d) t5 oracle call (B={DIALOG_B}, {len(live)} live): wall {br['wall_ms']:.1f} ms; "
                f"attention cores {br['t5 attention core']:.1f} ms in {br['calls']['t5 attention core']} calls; "
                f"f32 lm_head {br['t5 f32 lm_head']:.1f} ms in {br['calls']['t5 f32 lm_head']} calls")
            out.update(dialog_t5_attention_ms=br["t5 attention core"], dialog_t5_lm_head_ms=br["t5 f32 lm_head"])
    if on_card:
        res = _t5_card_vs_cpu(t5_config, device)
        log(f"dialog (3d) T5 card (bf16) vs CPU (f32), flan-t5-xl widths at {T5_CHECK_LAYERS} + {T5_CHECK_LAYERS} "
            f"layers: relative RMS error encoder {res['encoder']:.4f}, first-step logits {res['logits']:.4f}; the "
            f"CPU's own bf16: {res['encoder_cpu_bf16']:.4f}, {res['logits_cpu_bf16']:.4f} (bound {T5_RMS_FACTOR}x)")
    return out


def _counting_gate_hooks(record: list):
    """Patches that record, for every serving call, train step and score
    call a dialog gate makes, (kind, layers, new tokens, extra trunk
    forwards); restored by the returned undo."""
    from lmrl_gym_torch.algos import bc as bc_mod, ilql as ilql_mod, mc as mc_mod, value_policy as vp

    saved = []

    def patch(obj, name, fn):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, fn)

    gen_lm, gen_guided = vp.LMServer.generate, vp.ValueGuidedServer.generate

    def lm_generate(self, params, ids, mask, sampling, *a, **kw):
        record.append(("serve", params.config.num_layers, sampling.max_new_tokens, 1))
        return gen_lm(self, params, ids, mask, sampling, *a, **kw)

    def guided_generate(self, params, ids, mask, sampling, *a, **kw):
        trunks = 2 if params.pi_beta is not None and not self.share_trunk else 1
        record.append(("serve", params.base.config.num_layers, sampling.max_new_tokens, trunks))
        return gen_guided(self, params, ids, mask, sampling, *a, **kw)

    patch(vp.LMServer, "generate", lm_generate)
    patch(vp.ValueGuidedServer, "generate", guided_generate)
    for name in ("make_ilql_score_fn", "make_mc_score_fn"):
        make = getattr(vp, name)

        def counted_make(core, params, *a, _make=make, **kw):
            score = _make(core, params, *a, **kw)

            def counted(ids, am):
                record.append(("score", params.base.config.num_layers, 0, 1))
                return score(ids, am)
            return counted
        patch(vp, name, counted_make)

    def step_hook(make, kind):
        def counted_make(*a, **kw):
            step = make(*a, **kw)

            def counted(state, batch, *sa, **skw):
                if kind == "bc":
                    L, fwd = state.model.params.config.num_layers, 1
                elif kind == "ilql":
                    L = state.base.params.config.num_layers
                    fwd = 1 + (state.target_base_params is not None) + (batch.next_token_ids is not None)
                else:
                    L, fwd = state.base.params.config.num_layers, 1
                out = step(state, batch, *sa, **skw)
                record.append(("train", L, fwd, float(out[1])))
                return out
            return counted
        return counted_make

    patch(bc_mod, "make_bc_train_step", step_hook(bc_mod.make_bc_train_step, "bc"))
    patch(lm_oracle, "make_bc_train_step", step_hook(lm_oracle.make_bc_train_step, "bc"))
    patch(ilql_mod, "make_ilql_train_step", step_hook(ilql_mod.make_ilql_train_step, "ilql"))
    patch(mc_mod, "make_mc_train_step", step_hook(mc_mod.make_mc_train_step, "mc"))

    def undo():
        for obj, name, fn in reversed(saved):
            setattr(obj, name, fn)
    return undo


def phase_dialog_gates(device="cuda", extra=()) -> dict:
    """Phase 3e: the port's three dialog gates at their own widths (f32,
    d256 L4 H4 policies; oracle d128 / d256 L4, buyer d192 L4) and a cut
    budget (DIALOG_GATE_ARGS; episodes of DIALOG_GATE_TURNS turns and a
    smaller oracle QA set, `_cut_dialog_budget`): launch counts exactly the budget's — per
    serving call L K1 and L x new-token K4 per trunk (two trunks for the
    guided decode), per score call L K1, per BC and MC step L each of
    K1/K2/K3, per ILQL step 2L K1 (trained and target trunk) and L K2/K3 —
    all on the CUDA-core variants, as f32 runs them; finite losses; mean
    rewards in the env's range (20Q: [-20, 0]; Car-Dealer: finite) and every
    fidelity and probe accuracy in [0, 1]."""
    out = {}
    for name, module in (("car_dealer", car_dealer_ilql_gate), ("dialog_ilql", dialog_ilql_gate),
                         ("twenty_questions", twenty_questions_gate)):
        argv = DIALOG_GATE_ARGS[name] + list(extra) + ["--device", device]
        args = module.parse_args(argv)
        record: list = []
        undo = _counting_gate_hooks(record)
        try:
            with _cut_dialog_budget():
                result, counts, s = _counted(lambda: module.run(module.Gate(args)), device=device)
        finally:
            undo()
        want = [0] * 7
        for kind, L, n, extra_n in record:
            if kind == "serve":
                w = _want_f32(L, fwd=extra_n, dec=extra_n * n)
            elif kind == "score":
                w = _want_f32(L, fwd=1)
            else:
                w = _want_f32(L, fwd=n, bwd=1)
            want = [a + b for a, b in zip(want, w)]
        want = tuple(want)
        check(counts == want, f"dialog gate {name}: {_fmt_counts(counts)}, want {want}")
        losses = [r[3] for r in record if r[0] == "train"]
        check(all(math.isfinite(x) for x in losses), f"dialog gate {name}: losses {losses}")
        rewards = {k: v for k, v in result.get("all_evals", {}).items()}
        rewards.update({k: result[k] for k in ("bc_reward", "filtered_bc_reward") if k in result})
        if name == "car_dealer":
            check(all(math.isfinite(r) for r in rewards.values()), f"dialog gate {name}: rewards {rewards}")
        else:
            check(all(-20.0 <= r <= 0.0 for r in rewards.values()), f"dialog gate {name}: rewards {rewards}")
        rates = [result[k] for k in ("buyer_fidelity", "oracle_fidelity", "ilql_probe_acc", "mc_probe_acc")
                 if result.get(k) is not None]
        check(all(0.0 <= r <= 1.0 for r in rates), f"dialog gate {name}: rates {rates}")
        if name == "car_dealer":
            check(result["buyer_fidelity"] is not None, "dialog gate car_dealer: no LM buyer fidelity")
        n_kind = {k: sum(1 for r in record if r[0] == k) for k in ("serve", "score", "train")}
        log(f"dialog gate (3e) {name} ({' '.join(DIALOG_GATE_ARGS[name])}): {s:.1f} s, {n_kind['serve']} serving "
            f"calls, {n_kind['score']} score calls, {n_kind['train']} train steps, {_fmt_counts(counts)}; rewards "
            f"{ {k: round(v, 4) for k, v in rewards.items()} }, rates {rates}")
        out.update(_path_counts(f"dialog_gate_{name}", counts))
        out[f"dialog_gate_{name}_s"] = s
    return out


CLI_ARGS = ["--task", "wordle", "--algo", "ilql", "--model-size", "gpt2-small-real", "--tokenizer", "bpe",
            "--n-data", "64", "--epochs", "1", "--train-bsize", "16", "--eval-rollouts", "8"]
CLI_EXP = "cli"
CLI_MODULES = ("base", "target_base", "q1_head", "q2_head", "v_head", "q1_target_head", "q2_target_head")
DROPOUT_B, DROPOUT_T = 16, 160  # 3i's attention-dropout forward, card against CPU


def _cli_hooks(record: dict):
    """Wrap what `cli.train.main` and `cli.evaluate.main` call, to record
    each ILQL step (its launches, loss and seconds), each guided serving
    call (its seconds) and each checkpoint write. Returns the undo."""
    from lmrl_gym_torch.algos import ilql as ilql_module

    make, gfs, save = (ilql_module.make_ilql_train_step, ValueGuidedServer.generate_from_strs,
                       loop_checkpoints.CheckpointManager.save)
    device = record["device"]

    def make_ilql_train_step(*a, **kw):
        step = make(*a, **kw)

        def timed(state, batch, generator=None):
            before = _all_counts()
            t0 = time.perf_counter()
            state, loss, logs = step(state, batch, generator)
            _sync(device)
            record["steps"].append((time.perf_counter() - t0, tuple(b - a for a, b in zip(before, _all_counts())),
                                    loss.item()))
            return state, loss, logs

        return timed

    def generate_from_strs(self, *a, **kw):
        t0 = time.perf_counter()
        out = gfs(self, *a, **kw)
        _sync(device)
        record["calls"].append(time.perf_counter() - t0)
        record["actions"].append(list(out))
        return out

    def manager_save(self, *a, **kw):
        t0 = time.perf_counter()
        out = save(self, *a, **kw)
        record["saves"].append(time.perf_counter() - t0)
        return out

    ilql_module.make_ilql_train_step = make_ilql_train_step
    ValueGuidedServer.generate_from_strs = generate_from_strs
    loop_checkpoints.CheckpointManager.save = manager_save

    def undo():
        ilql_module.make_ilql_train_step = make
        ValueGuidedServer.generate_from_strs = gfs
        loop_checkpoints.CheckpointManager.save = save

    return undo


def phase_cli(device="cuda", config=None, dropout_config=None) -> dict:
    """Phase 3i: the command line at full width. `cli.train.main` runs
    CLI_ARGS: ILQL on Wordle at GPT-2-small over the task BPE with the full
    50,257-id vocabulary (padded to 50,304) and the size's default dropout
    (attention-probability dropout 0.1 among it), 64 behavior episodes, one
    epoch of four B=16 steps, one eval of 8 value-guided games, and the
    JAX package's checkpoint layout. Its launches are exact: none in the
    trained steps (attention dropout takes the einsum route; the target
    and next-window forwards train too), L K1 and 32·L K4 per guided
    serving call of the eval. `cli.evaluate.main` then reads the checkpoint
    (it infers ilql and decodes guided) and must reproduce the train CLI's
    eval: every decoded action and the mean reward; `export_hf_pretrained` / `load_hf_pretrained` round-trip
    the trained base with `transformers` and `safetensors` blocked, to
    bit-identical logits; and one attention-dropout training forward
    (B=16, T=160, f32, keep masks replayed) on the card is held against
    the CPU. `config` / `dropout_config` replace GPT-2-small for a CPU
    rehearsal."""
    from lmrl_gym_torch.cli import evaluate as cli_evaluate
    from lmrl_gym_torch.cli import train as cli_train
    from lmrl_gym_torch.models import hf as hf_interop

    argv = list(CLI_ARGS)
    if config is not None:  # a rehearsal size
        cli_train.MODEL_SIZES["rehearsal"] = lambda: config
        argv[argv.index("gpt2-small-real")] = "rehearsal"
    out = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    record = dict(device=device, steps=[], calls=[], actions=[], saves=[])
    undo = _cli_hooks(record)
    try:
        t0 = time.perf_counter()
        (state, loop_state), counts, s_train = _counted(
            cli_train.main, argv + ["--save-dir", root, "--exp-name", CLI_EXP, "--device", device], device=device)
        L = state.base.params.config.num_layers
        n_calls, n_steps = len(record["calls"]), len(record["steps"])
        want = _want(L, fwd=n_calls, dec=32 * n_calls)
        check(n_steps == 4 and n_calls >= 1, f"cli (3i): {n_steps} steps, {n_calls} serving calls")
        check(counts == want, f"cli (3i) train: {_fmt_counts(counts)}, want {want}")
        zero = (0,) * len(COUNT_NAMES)
        check(all(c == zero for _, c, _ in record["steps"]),
              f"cli (3i): ILQL steps launched {[c for _, c, _ in record['steps']]}")
        losses = [x for _, _, x in record["steps"]]
        check(all(math.isfinite(x) for x in losses), f"cli (3i): losses {losses}")
        run_dir = os.path.join(root, CLI_EXP)
        for tag in ("best", "last"):
            for name in CLI_MODULES:
                check(os.path.exists(os.path.join(run_dir, tag, name, "params.msgpack")), f"cli (3i): no {tag}/{name}")
            check(os.path.exists(os.path.join(run_dir, tag, "base", "config.json")), f"cli (3i): no {tag} config")
            check(os.path.exists(os.path.join(run_dir, tag, "loop_state.pkl")), f"cli (3i): no {tag} loop state")
        reward = loop_state.best_perf
        check(math.isfinite(reward), f"cli (3i): eval reward {reward}")
        step_s, call_s, save_s = sum(x for x, _, _ in record["steps"]), sum(record["calls"]), sum(record["saves"])
        ckpt_gb = _dir_bytes(os.path.join(run_dir, "last")) / 1e9
        log(f"cli (3i) train: {s_train:.2f} s: {n_steps} ILQL steps {step_s:.2f} s "
            f"({[round(x, 3) for x, _, _ in record['steps']]}), eval {n_calls} guided calls {call_s:.2f} s, "
            f"{len(record['saves'])} checkpoint writes {save_s:.2f} s ({ckpt_gb:.3f} GB each), the rest (BPE, "
            f"data, init) {s_train - step_s - call_s - save_s:.2f} s; losses {[round(x, 4) for x in losses]}; "
            f"eval reward {reward}; {_fmt_counts(counts)}")
        out.update(_path_counts("cli_train", counts))
        out.update(cli_train_s=s_train, cli_step_s=step_s / n_steps, cli_eval_s=call_s)

        # the standalone evaluation of the same checkpoint
        train_actions = list(record["actions"])
        record["calls"].clear()
        record["actions"].clear()
        eval_argv = ["--task", "wordle", "--checkpoint", run_dir, "--tokenizer", f"bpe:{run_dir}/bpe.json",
                     "--n-rollouts", "8", "--device", device]
        results, counts, s_eval = _counted(cli_evaluate.main, eval_argv, device=device)
        n_eval_calls = len(record["calls"])
        want = _want(L, fwd=n_eval_calls, dec=32 * n_eval_calls)
        check(counts == want, f"cli (3i) evaluate: {_fmt_counts(counts)}, want {want}")
        eval_reward = results["rollouts"]["reward"]["mean"]
        log(f"cli (3i) evaluate: {s_eval:.2f} s, {n_eval_calls} guided calls; reward {eval_reward} (train CLI's eval "
            f"{reward}); {_fmt_counts(counts)}")
        check(eval_reward == reward, f"cli (3i): evaluate reward {eval_reward} != the train CLI's eval {reward}")
        check(record["actions"] == train_actions, "cli (3i): evaluate decoded other actions than the train CLI's eval")
        out.update(_path_counts("cli_evaluate", counts))
        out.update(cli_evaluate_s=s_eval)

        # HF round trip of the trained base, with no transformers present
        base = state.base.params
        blocked = {m: sys.modules.get(m) for m in ("transformers", "safetensors")}
        t0 = time.perf_counter()
        try:
            for m in blocked:
                sys.modules[m] = None
            hf_dir = os.path.join(root, "hf")
            hf_interop.export_hf_pretrained(base, base.config, hf_dir)
            # the activation dtype is the caller's choice: HF's config does not carry it
            hf_config, loaded = hf_interop.load_hf_pretrained(hf_dir, device=device, dtype=base.config.dtype)
        finally:
            for m, mod in blocked.items():
                if mod is None:
                    sys.modules.pop(m, None)
                else:
                    sys.modules[m] = mod
        s_hf = time.perf_counter() - t0
        g = torch.Generator().manual_seed(3)
        ids = torch.randint(0, hf_config.vocab_size, (4, 32), generator=g).to(device)
        V = hf_config.vocab_size  # the padded vocab rows are stripped on export and zero-filled on import
        with torch.no_grad():
            same = torch.equal(base(ids)[0][..., :V], loaded(ids)[0][..., :V])
        log(f"cli (3i) HF round trip: export + load {s_hf:.2f} s ({_dir_bytes(hf_dir) / 1e9:.3f} GB), logits over "
            f"the {V}-id vocabulary bit-identical: {same}")
        check(same and hf_config.padded_vocab_size == base.config.padded_vocab_size, "cli (3i): HF round trip logits")
        del state, base, loaded
    finally:
        undo()
        cli_train.MODEL_SIZES.pop("rehearsal", None)
        shutil.rmtree(root, ignore_errors=True)
    out.update(_dropout_card_vs_cpu(device, dropout_config))
    return out


def _dropout_card_vs_cpu(device, config=None) -> dict:
    """One attention-dropout training forward (f32, embedding and residual
    dropout 0, the keep masks drawn on the CPU at attn_pdrop and replayed)
    on `device` against the CPU: relative RMS logit difference within
    STEP_LOSS_RTOL, no K1 launch."""
    cfg = (config or gpt2_small()).replace(dtype="float32", embd_pdrop=0.0, resid_pdrop=0.0)
    b, t = (DROPOUT_B, DROPOUT_T) if config is None else (2, 16)
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (b, t), generator=g)
    keeps = [torch.rand(b, cfg.num_heads, t, t, generator=g) < 1.0 - cfg.attn_pdrop for _ in range(cfg.num_layers)]
    causal = torch.ones(t, t, dtype=torch.bool).tril()
    share = torch.stack([k[:, :, causal] for k in keeps]).float().mean().item()
    model = Transformer(cfg, device=device, seed=5)  # drawn on `device`: seconds faster than on the CPU
    cpu_model = copy.deepcopy(model).to("cpu")
    t0 = time.perf_counter()
    with torch.no_grad():
        (logits, _, _), counts, s_card = _counted(model, ids.to(device), deterministic=False,
                                                  attn_keep=[k.to(device) for k in keeps], device=device)
        ref = cpu_model(ids, deterministic=False, attn_keep=keeps)[0]
    rel = ((logits.cpu() - ref).double().norm() / ref.double().norm()).item()
    plain = model(ids.to(device))[0].cpu()
    moved = ((plain - ref).double().norm() / ref.double().norm()).item()
    log(f"cli (3i) attention dropout (attn_pdrop {cfg.attn_pdrop}, f32, B={b} T={t}, masks replayed): card vs CPU "
        f"relative RMS logit diff {rel:.2e} (tol {STEP_LOSS_RTOL}); keep share {share:.4f}; without dropout the "
        f"logits move by {moved:.2e}; card forward {s_card:.3f} s, both {time.perf_counter() - t0:.2f} s; "
        f"{_fmt_counts(counts)}")
    check(rel <= STEP_LOSS_RTOL and moved > 10 * STEP_LOSS_RTOL, f"cli (3i): dropout forward card vs CPU {rel}")
    check(counts == (0,) * len(COUNT_NAMES), f"cli (3i): the dropout forward launched {_fmt_counts(counts)}")
    check(abs(share - (1.0 - cfg.attn_pdrop)) < 0.005, f"cli (3i): keep share {share}")
    return dict(dropout_rel_err=rel, dropout_keep_share=share)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _max_diff(got: dict, ref: dict) -> float:
    return max((got[k].float() - ref[k].float()).abs().max().item() for k in ref)


def _scaling_rows(device) -> None:
    """`scaling.main`'s rows on this one card, in the one-rank group that is
    up (3x's): the n = 1 rows measured (on the card the env and ILQL
    weak-scaling rows, fixed total work and the census; gloo ranks skip
    the weak rows), each ILQL step's launches 3L / L / L on the tensor
    cores, the census at (1, 1, 1) empty, every n > 1 row not run."""
    record, sections = {}, {}
    with recorded_scripts(record, sections) as current:
        current[0] = "scaling"
        t0 = time.perf_counter()
        rows = scaling.main(["--device", device, "--max-devices", "1"])
        log(f"3x scaling.main (one-rank rows): {time.perf_counter() - t0:.1f} s")
    _check_steps("scaling", record["scaling"])
    ran = [r for r in rows if "not_run" not in r]
    check(all(r["n_devices"] == 1 for r in ran) and len(ran) == (4 if device == "cuda" else 2), f"scaling: rows run {ran}")
    check(all(r["not_run"] == "one device" for r in rows if "not_run" in r), "scaling: a row neither run nor marked")
    census = [r for r in ran if r["workload"] == "ilql_collective_census"]
    check(len(census) == 1 and census[0]["mesh"] == "dp1 fsdp1 mp1" and census[0]["census"] == {},
          f"scaling: the (1, 1, 1) census {census}")


SHARDED_REPS = 3  # 3x's timed steps


def phase_sharded(config, device="cuda") -> dict:
    """Phase 3x: the sharded code on the card in a one-rank group
    (`core/io.py::distributed_init` with explicit arguments: NCCL, rank 0 of
    1, a local address). Phase 3t's ILQL step runs through `load_mesh((1,
    1, 1))` and `shard_train_state`, every module wrapped by FSDP2 by its
    rule table, beside the unsharded step from the same weights and batch:
    one warm-up and SHARDED_REPS timed steps each, every step's launches
    exact (3·L / L / L, all tensor-core); the losses and the updated
    parameters of every module against the unsharded ones (the largest
    difference printed and held to 1e-6); one step of each profiled (device
    busy time; the sharded step's NCCL kernels, count and device time, and
    FSDP2's unshard and reduce events). Then the sharded V head's train
    state written (gathered whole, rank 0 writes) against the unsharded
    state's write, byte for byte, and the V head read
    back into a fresh sharded head through the stream-sharded read; then
    `make_ring_attention` over a one-rank sp mesh at the Text-Nav windows'
    bf16 shapes (B=32, H=12, T=640, Dh=64, right-padded) against K1's
    output. The group is destroyed at the end."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.profiler import ProfilerActivity, profile

    from lmrl_gym_torch.core.io import distributed_init
    from lmrl_gym_torch.parallel.mesh import MESH_AXES_SP, full_state_dict, is_sharded, load_mesh, shard_module
    from lmrl_gym_torch.parallel.ring_attention import make_ring_attention

    L = config.num_layers
    want = (3 * L, L, L)
    t_phase = time.perf_counter()
    check(distributed_init(f"localhost:{_free_port()}", 1, 0, device=device, timeout_s=120), "no group started")
    try:
        backend = dist.get_backend()
        check(backend == ("nccl" if device == "cuda" else "gloo"), f"backend {backend}")
        mesh = load_mesh((1, 1, 1), device=device)
        # the port's scaling setup (bench's state from seeds, sharded by the rule
        # tables) beside the same state unsharded, on bench's batch
        batch = scaling._make_batch(TRAIN_B, TRAIN_T, mesh)
        ref, ref_step = port_bench.ilql_state(config, 256, device)
        state, step = scaling._make_ilql_setup(mesh, config)
        fields = ("base", "target_base_params", "q1_head", "q2_head", "v_head", "q1_target_params", "q2_target_params")

        def module(st, f):
            m = getattr(st, f)
            return m.params if isinstance(m, TrainState) else m

        check(all(is_sharded(module(state, f)) and all(isinstance(p, DTensor) for p in module(state, f).parameters())
                  for f in fields), "3x: a module is not wrapped by FSDP2")
        losses, times = {"unsharded": [], "sharded": []}, {"unsharded": [], "sharded": []}
        for i in range(1 + SHARDED_REPS):
            for name, fn, st in (("unsharded", ref_step, ref), ("sharded", step, state)):
                _reset_counts()
                _sync(device)
                t0 = time.perf_counter()
                st, loss, _ = fn(st, batch)
                _sync(device)
                if i:  # the first is the warm-up
                    times[name].append(time.perf_counter() - t0)
                check(_train_counts() == want, f"3x {name} step launched {_train_counts()}, want {want}")
                check(_tc_counts() == (L, L) and flash_fwd.tc_launches == 3 * L,
                      f"3x {name} step: tensor-core launches {_tc_counts()} / {flash_fwd.tc_launches}")
                losses[name].append(loss.item())
        check(all(math.isfinite(x) for x in losses["sharded"]), f"3x losses {losses['sharded']}")
        loss_diff = max(abs(a - b) for a, b in zip(losses["sharded"], losses["unsharded"]))
        param_diff = max(_max_diff(full_state_dict(module(state, f)), module(ref, f).state_dict()) for f in fields)
        log(f"3x sharded ILQL step (mesh {mesh.shape}, backend {backend}, FSDP2 on {len(fields)} modules): "
            f"losses {[round(x, 6) for x in losses['sharded']]}; largest difference from the unsharded step: "
            f"loss {loss_diff:.3e}, parameters {param_diff:.3e}")
        check(loss_diff <= 1e-6 * max(1.0, abs(losses["unsharded"][-1])) and param_diff <= 1e-6,
              f"3x sharded step apart from the unsharded one: loss {loss_diff}, parameters {param_diff}")
        med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
        prof_out = {}
        for name, fn, st in (("unsharded", ref_step, ref), ("sharded", step, state)):
            for _ in range(PROFILER_TRIES):  # each try is one more step: both states take as many
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    fn(st, batch)
                    _sync(device)
                events = prof.key_averages()
                kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
                if device != "cuda" or sum(e.self_device_time_total for e in kernels) > 0:
                    break
            prof_out[name] = (events, kernels)
        events, kernels = prof_out["sharded"]
        nccl = [e for e in kernels if "nccl" in e.key.lower()]
        fsdp = {e.key: e.count for e in events if e.key in ("FSDP::pre_forward", "FSDP::post_backward_reduce")}
        busy = {k: sum(e.self_device_time_total for e in v[1]) / 1e3 for k, v in prof_out.items()}
        log(f"3x step time: sharded median {1e3 * med['sharded']:.1f} ms (min {1e3 * min(times['sharded']):.1f}), "
            f"unsharded median {1e3 * med['unsharded']:.1f} ms (min {1e3 * min(times['unsharded']):.1f}); device "
            f"busy per step {busy['sharded']:.1f} ms sharded, {busy['unsharded']:.1f} ms unsharded; NCCL kernels per "
            f"sharded step {sum(e.count for e in nccl)}, device time {sum(e.self_device_time_total for e in nccl) / 1e3:.2f}"
            f" ms; FSDP2 events {fsdp}")
        extra = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in kernels
                        if e.key not in {u.key for u in prof_out["unsharded"][1]}), reverse=True)[:4]
        for ms, n, key in extra:
            log(f"  kernel only in the sharded step: {ms:8.2f} ms x{n:4d}  {key[:100]}")

        root = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
        try:
            t0 = time.perf_counter()
            for name, st in (("sharded", state), ("whole", ref)):
                loop_checkpoints.dump_modules(os.path.join(root, name), {"v_head": st.v_head}, save_train_state=True)
            for rel in ("v_head/train_state.msgpack",):
                with open(os.path.join(root, "sharded", rel), "rb") as f, open(os.path.join(root, "whole", rel), "rb") as g:
                    check(f.read() == g.read(), f"3x: the sharded write of {rel} differs from the unsharded write")
            t_write = time.perf_counter() - t0
            v_cfg = state.v_head.params.config
            fresh = shard_module(MLPHead(v_cfg, device=device, seed=99), mesh)
            t0 = time.perf_counter()
            restore_module(os.path.join(root, "sharded"), "v_head", fresh)
            check(_max_diff(full_state_dict(fresh), full_state_dict(state.v_head.params)) == 0.0,
                  "3x: the stream-sharded read differs from the written state")
            log(f"3x checkpoint: sharded and unsharded writes ({_dir_bytes(os.path.join(root, 'sharded')) / 1e6:.1f} MB "
                f"each) byte-identical, both in {t_write:.2f} s; stream-sharded read {time.perf_counter() - t0:.2f} s")
        finally:
            shutil.rmtree(root, ignore_errors=True)

        sp_mesh = load_mesh((1, 1, 1, 1), MESH_AXES_SP, device=device)
        gen = torch.Generator(device=device).manual_seed(5)
        b, h, t, dh = TRAIN_B, H, TN_LEN, DH
        q, k, v = (torch.randn(b, h, t, dh, generator=gen, device=device).to(torch.bfloat16) for _ in range(3))
        lengths = torch.randint(t // 2, t + 1, (b,), generator=gen, device=device)
        bias = torch.where(torch.arange(t, device=device)[None, :] < lengths[:, None], 0.0, _NEG_BIG).float()
        ring_out = make_ring_attention(sp_mesh, sm_scale=1.0 / math.sqrt(dh))(q, k, v, bias)
        k1_out = flash_fwd(q, k, v, bias, causal=True, sm_scale=1.0 / math.sqrt(dh))[0]
        err = excess(ring_out, k1_out, torch.bfloat16).max().item()
        check(err <= TOL[torch.bfloat16][0], f"3x ring attention against K1: excess {err}")
        log(f"3x ring attention over a one-rank sp mesh against K1 (B={b} H={h} T={t} Dh={dh} bf16, right-padded): "
            f"max |ring − K1| {(ring_out.float() - k1_out.float()).abs().max().item():.3e}")
        _scaling_rows(device)
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "3x: the group is still up")
    log(f"phase 3x: {time.perf_counter() - t_phase:.1f} s")
    names = ("flash_fwd_sharded_step", "flash_bwd_dq_sharded_step", "flash_bwd_dkv_sharded_step",
             "flash_fwd_tc_sharded_step", "flash_bwd_dq_tc_sharded_step", "flash_bwd_dkv_tc_sharded_step")
    return dict(zip(names, want + (3 * L, L, L)))


# GPT-J-6B (slice 12): value-guided serving at full width and depth
GPTJ_B = 256  # the rollout's games (B = 512 would need ~88 GB)
GPTJ_TURN_B = 16  # a served Text-Nav turn's prompts (TN_LEN tokens, TN_NEW new)
GPTJ_REPS = 1  # timed rollouts and turns, each after one warm-up
GPTJ_CPU_LAYERS = 2  # the card-vs-CPU logits check's depth: the CPU holds 2 layers at d4096 in f32
GPTJ_ROLLOUT_FLASH = [(8, 8)] + [(10, 28 + 20 * t) for t in range(N_TRIES)]  # K1 (Tq, S) per trunk and layer
GPTJ_ROLLOUT_FILLS = [8 + 20 * t + s for t in range(N_TRIES) for s in range(10)]  # K4 cache index per step
GPTJ_TURN_FILLS = list(range(TN_LEN, TN_LEN + TN_NEW))
GPTJ_FILL_STRIDE = 3  # 2j times K4 at every third fill of a path: its time is linear in the fill


def gptj_config():
    """`models/config.py::gptj_6b` as published: vocab 50,400 padded to
    50,432, 28 layers, d 4096, 16 heads (Dh 256), rotary_dim 64
    interleaved, parallel FFN, untied lm_head."""
    config = gptj_6b()
    check((config.padded_vocab_size, config.num_layers, config.hidden_size, config.head_dim) == (50432, 28, 4096, 256),
          f"gptj_6b: {config}")
    return config


def _gptj_flash_row(b, h, dh, Tq, S, t_max, padded, gen, sdpa_fn) -> dict:
    """K1 at one GPT-J shape, bf16 on a cache view: checked against the
    plain version (on the tensor-core route), then the kernel's, plain
    version's, SDPA's and the CUDA-core variant's ms and the bound."""
    dtype = torch.bfloat16
    q, k, v, bias = _flash_inputs(Tq, S, dtype, padded, gen, b, h, t_max=t_max, dh=dh)
    rows = torch.ones(b, Tq, dtype=torch.bool, device="cuda") if bias is None else bias[:, S - Tq:] == 0
    tc0 = flash_fwd.tc_launches
    err, lse_err = _check_fwd(q, k, v, bias, rows, dtype, f"GPT-J B={b} Tq={Tq} S={S} padded={padded}")
    n_tc = flash_fwd.tc_launches - tc0
    check(n_tc == 1, f"flash_fwd GPT-J B={b} Tq={Tq} S={S}: tensor-core launches {n_tc}, want 1")
    scale = 1.0 / dh**0.5
    mask = sdpa_mask(bias, Tq, S, b)
    row = dict(ms=cuda_ms(lambda: flash_fwd(q, k, v, bias, True, scale)),
               plain_ms=cuda_ms(lambda: _plain_attention(q, k, v, bias, True, scale), 5, 1),
               library_ms=cuda_ms(lambda: sdpa_fn(q, k, v, attn_mask=mask, scale=scale)))
    with forced_variant("simt"):
        row["simt_ms"] = cuda_ms(lambda: flash_fwd(q, k, v, bias, True, scale), 5, 1)
    row["bound_ms"], row["bound_by"] = bound_ms(*flash_work(b, h, dh, Tq, S, dtype), dtype)
    log(f"check flash_fwd GPT-J B={b} H={h} Dh={dh} Tq={Tq} S={S} (view of {t_max}) left_pad={padded} bf16: "
        f"max_abs_err={err:.3e} (atol, rtol {TOL[dtype]}) lse_err={lse_err:.3e} tc_launches={n_tc} "
        + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items())
        + f" bound_share={row['bound_ms'] / row['ms']:.3f}")
    return dict(row, err=err)


def _gptj_decode_row(b, h, dh, index, t_max, padded, gen, sdpa_fn, reps=20) -> dict:
    """K4 at one GPT-J fill, bf16: checked, then kernel, plain, SDPA ms and the bound."""
    dtype = torch.bfloat16
    q, k, v, bias = _decode_inputs(index, dtype, padded, gen, b, h, t_max=t_max, max_pad=TN_LEN - 1, dh=dh)
    err = _check_decode(q, k, v, index, bias, dtype, f"GPT-J B={b} index={index}")
    scale = 1.0 / dh**0.5
    n = index + 1
    kp, vp = k[:, :, :n], v[:, :, :n]
    mask = None if bias is None else (bias[:, :n] == 0)[:, None, None, :]
    row = dict(ms=cuda_ms(lambda: decode_attention(q, k, v, index, bias, scale), reps),
               plain_ms=cuda_ms(lambda: _plain_decode_attention(q, k, v, index, bias, scale), max(2, reps // 4), 1),
               library_ms=cuda_ms(lambda: sdpa_fn(q, kp, vp, attn_mask=mask, scale=scale), reps))
    row["bound_ms"], row["bound_by"] = bound_ms(*decode_work(b, h, dh, n, dtype), dtype)
    return dict(row, err=err)


def _mean_rows(rows: list) -> dict:
    """Per-launch means over a path's launches; bound_by of the heaviest."""
    out = {k: sum(r[k] for r in rows) / len(rows) for k in rows[0] if k not in ("bound_by", "err")}
    out["bound_by"] = max(rows, key=lambda r: r["bound_ms"])["bound_by"]
    out["err"] = max(r["err"] for r in rows)
    return out


def phase_gptj_kernel_checks() -> dict:
    """Phase 2j: K1 and K4 at GPT-J-6B's Dh = 256, bf16, against their
    plain versions, with kernel, plain, SDPA (and for K1 the CUDA-core
    variant's) ms and the bound at each shape: K1 at the rollout's shapes
    (B=256, H=16; the header prefill Tq=S=8 and the appends Tq=10 over
    S = 28..128, views of a 128-slot cache) and the served Text-Nav turn's
    prefill (B=16, Tq=S=640 of a 676-slot cache, with and without left
    padding); K4 at the rollout's 60 fills (B=256) and the turn's 36
    (B=16, left-padded). Returns per kernel the per-launch means over each
    path's launches ("gptj_rollout", "gptj_turn") and the max errors."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    h, dh = GPTJ_H, GPTJ_DH
    roll = [_gptj_flash_row(GPTJ_B, h, dh, Tq, S, T_MAX, False, gen, sdpa) for Tq, S in GPTJ_ROLLOUT_FLASH]
    turn = [_gptj_flash_row(GPTJ_TURN_B, h, dh, TN_LEN, TN_LEN, TN_LEN + TN_NEW, padded, gen, sdpa)
            for padded in (False, True)]
    out = {"flash_fwd_gptj_rollout": _mean_rows(roll), "flash_fwd_gptj_turn": _mean_rows(turn[1:])}
    out["flash_fwd_gptj_turn"]["err"] = max(r["err"] for r in turn)
    # 3jt's ILQL step (Jtr): the windows of B=32, T=160, no padding bias
    out["flash_fwd_gptj_train_step"] = _gptj_flash_row(TRAIN_B, h, dh, TRAIN_T, TRAIN_T, TRAIN_T, False, gen, sdpa)
    dec_roll = [_gptj_decode_row(GPTJ_B, h, dh, index, T_MAX, False, gen, sdpa, reps=5)
                for index in GPTJ_ROLLOUT_FILLS[1::GPTJ_FILL_STRIDE]]
    dec_turn = [_gptj_decode_row(GPTJ_TURN_B, h, dh, index, TN_LEN + TN_NEW, True, gen, sdpa, reps=5)
                for index in GPTJ_TURN_FILLS[GPTJ_FILL_STRIDE - 1::GPTJ_FILL_STRIDE]]
    for index in (8, 67, 127):  # phase 2's decode checks, at B=256 and Dh=256
        r = _gptj_decode_row(GPTJ_B, h, dh, index, T_MAX, False, gen, sdpa)
        log(f"check decode_attn GPT-J B={GPTJ_B} H={h} Dh={dh} T_max={T_MAX} index={index} bf16: "
            f"max_abs_err={r['err']:.3e} ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} bound_share={r['bound_ms'] / r['ms']:.3f}")
    r = dec_turn[-1]  # the turn's last step
    log(f"check decode_attn GPT-J B={GPTJ_TURN_B} H={h} Dh={dh} T_max={TN_LEN + TN_NEW} index={GPTJ_TURN_FILLS[-1]} "
        f"left-padded bf16: max_abs_err={r['err']:.3e} ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
        f"library_ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f} bound_share={r['bound_ms'] / r['ms']:.3f}")
    out["decode_attn_gptj_rollout"] = _mean_rows(dec_roll)
    out["decode_attn_gptj_turn"] = _mean_rows(dec_turn)
    for name, row in out.items():
        log(f"GPT-J path shapes {name} (bf16, Dh=256, mean per launch): " + " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items())
            + f" bound_share={row['bound_ms'] / row['ms']:.3f}")
    return out


def gptj_text_nav_prompts(n: int) -> list:
    """n Text-Nav histories as served prompts: `TextNavEnv` games from
    seeds 0..n−1, each 0 to 5 moves in under its walkthrough agent, as
    strings (the server cuts and left-pads them to TN_LEN byte tokens)."""
    prompts = []
    for i in range(n):
        env = TextNavEnv()
        hist = env.reset(seed=i)
        agent = WalkthroughAgent(env)
        for _ in range(i % 6):
            hist, _, done = env.step(agent.act(hist))
            if done:
                break
        prompts.append(text_history_to_str(hist))
    return prompts


def phase_gptj() -> dict:
    """Phase 3j: value-guided serving at GPT-J-6B's full width and depth
    (bf16 weights from a seed): two trunks, twin MLP Q heads (f32, hidden
    8,192, out 50,432), beta=32. The fused Wordle rollout at B=256 on the
    constrained vocab — one warm-up, GPTJ_REPS timed with exact launches
    worked out from the code before the run (per trunk and layer 7 K1: the
    header prefill and six observation appends; 60 K4: the decode steps;
    392 and 3,360 in all, every K1 on the tensor cores), the rollout's
    invariants, env-steps/s, tokens/s and peak memory, then one rollout
    profiled; then, its caches freed, a served Text-Nav turn:
    `ValueGuidedServer.generate_from_strs` on B=16 Text-Nav histories
    left-padded to 640 byte tokens, 36 sampled new tokens (per trunk and
    layer one K1 prefill and 36 K4: 56 and 2,016), one warm-up and
    GPTJ_REPS timed; and the trunk cut to GPTJ_CPU_LAYERS layers at full
    width, bf16 on the card against f32 on the CPU (phase 4's check)."""
    config = gptj_config()
    L = config.num_layers
    core = LMCore(config, device="cuda")
    t0 = time.perf_counter()
    pi_beta = init_params(config, seed=60, device="cuda", dtype=torch.bfloat16)
    base = init_params(config, seed=61, device="cuda", dtype=torch.bfloat16)
    head_cfg = MLPHeadConfig(input_dim=config.hidden_size, hidden_dim=2 * config.hidden_size,
                             output_dim=config.padded_vocab_size)
    q1, q2 = MLPHead(head_cfg, device="cuda", seed=62), MLPHead(head_cfg, device="cuda", seed=63)
    env = WordleVectorEnv(WordleVocab.from_file(), device="cuda")
    params = {"pi_beta": pi_beta, "base": base, "q1": q1, "q2": q2}
    step_fn, carry0 = actor.make_value_guided_step_fn(core, GPTJ_B, two_trunks=True, twin_q=True, beta=32.0)
    gen = torch.Generator(device="cuda").manual_seed(12)
    torch.cuda.synchronize()
    n_params = port_bench.n_params(base)
    log(f"GPT-J setup (3j): two {n_params / 1e9:.3f}B-parameter trunks bf16 ({config.num_layers} layers, d"
        f"{config.hidden_size}, {config.num_heads} heads of {config.head_dim}), twin MLP Q heads f32 "
        f"({2 * port_bench.n_params(q1) / 1e9:.3f}B), B={GPTJ_B}: {time.perf_counter() - t0:.2f} s")

    def rollout():
        return actor.rollout_wordle(env, step_fn, params, carry0, GPTJ_B, constrain_vocab=True, generator=gen)

    t0 = time.perf_counter()
    rollout()
    torch.cuda.synchronize()
    log(f"GPT-J warm-up rollout: {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    want_roll = _want(L, fwd=2 * 7, dec=2 * 60)
    times = []
    for rep in range(GPTJ_REPS):
        out, counts, s = _counted(rollout)
        check(counts == want_roll, f"GPT-J rollout {rep}: {_fmt_counts(counts)}, want {want_roll}")
        check(counts.split == 0, f"GPT-J rollout {rep}: {counts.split} split-route decode launches (Dh = 256)")
        _check_rollout(out, env, GPTJ_B)
        times.append(s)
        log(f"GPT-J rollout {rep} B={GPTJ_B}: {s:.4f} s, {_fmt_counts(counts)}, return "
            f"{(out.turn_reward * out.turn_live).sum(1).mean().item():.3f} turns {out.n_turns.float().mean().item():.2f}")
    dt = sorted(times)[len(times) // 2]
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"GPT-J rollout median of {GPTJ_REPS}: {dt:.4f} s (min {min(times):.4f}, max {max(times):.4f}), "
        f"env_steps_per_s={GPTJ_B * N_TRIES / dt:.1f} tokens_per_s={GPTJ_B * actor.EPISODE_LEN / dt:.1f} "
        f"peak_mem_gb={peak:.2f}")
    profile_run("GPT-J rollout", rollout, dt)
    out = _path_counts("gptj_rollout", counts)
    del rollout, step_fn, carry0
    torch.cuda.empty_cache()

    server = ValueGuidedServer(core, ByteTokenizer(), beta=32.0)
    serving = ValueRLParams(pi_beta, base, q1, q2, None)
    prompts = gptj_text_nav_prompts(GPTJ_TURN_B)
    sampling = SamplingConfig(max_new_tokens=TN_NEW, pad_token_id=256)
    turn_gen = torch.Generator(device="cuda").manual_seed(13)

    def turn():
        return server.generate_from_strs(serving, prompts, TN_LEN, sampling, turn_gen)

    t0 = time.perf_counter()
    turn()
    torch.cuda.synchronize()
    log(f"GPT-J warm-up Text-Nav turn: {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    want_turn = _want(L, fwd=2, dec=2 * TN_NEW)
    times = []
    for rep in range(GPTJ_REPS):
        answers, counts, s = _counted(turn)
        check(counts == want_turn, f"GPT-J Text-Nav turn {rep}: {_fmt_counts(counts)}, want {want_turn}")
        check(counts.split == 0, f"GPT-J Text-Nav turn {rep}: {counts.split} split-route decode launches (Dh = 256)")
        check(len(answers) == GPTJ_TURN_B and all(isinstance(a, str) for a in answers), "GPT-J Text-Nav turn answers")
        times.append(s)
    dt = sorted(times)[len(times) // 2]
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_tok = [len(ByteTokenizer().encode(p)) for p in prompts]
    log(f"GPT-J Text-Nav turn (ValueGuidedServer, B={GPTJ_TURN_B}, prompts of {min(n_tok)}-{max(n_tok)} bytes "
        f"left-padded or cut to {TN_LEN}, {TN_NEW} new): median of {GPTJ_REPS} {dt:.4f} s (min {min(times):.4f}, "
        f"max {max(times):.4f}), new_tokens_per_s={GPTJ_TURN_B * TN_NEW / dt:.1f}, {_fmt_counts(counts)}, "
        f"peak_mem_gb={peak:.2f}; answer 0 {answers[0][:40]!r}")
    out.update(_path_counts("gptj_turn", counts))
    del server, serving, params, pi_beta, base, q1, q2
    torch.cuda.empty_cache()

    cut = config.replace(num_layers=GPTJ_CPU_LAYERS)
    cut_base = init_params(cut, seed=61, device="cuda", dtype=torch.bfloat16)
    log(f"GPT-J cut to {GPTJ_CPU_LAYERS} layers at full width for the card-vs-CPU check:")
    phase_card_vs_cpu(cut_base, cut)
    return out


# GPT-J-6B training (slice 13): the ILQL and BC steps at full width, depth cut
GPTJ_TRAIN_LAYERS = 6  # f32 parameters with Adam (16 B each): 28 layers' trunk alone would need ~97 GB
GPTJ_TRAIN_REPS = 3  # 3jt's timed ILQL steps, after one warm-up and before one profiled
GPTJ_BC_REPS = 3  # 3jt's BC steps at the Text-Nav window
# card (bf16 activations, tensor-core kernels) vs CPU (f32, plain versions)
# ILQL step at 2 layers, full width, relative: bf16 keeps ~3 significant
# digits per op, so the loss moves by ~5e-4 and each group's gradient by
# ~1% of its norm (bf16 against f32 on the CPU at d512 and d1024), not by
# the f32 step's summation order; 20x and ~4x headroom for d4096
GPTJ_STEP_TOLS = (1e-2, 5e-2)  # (loss, gradient norm)


def _gptj_train_card_vs_cpu(config) -> None:
    """One ILQL step's loss and gradients at GPTJ_CPU_LAYERS layers and
    full width, B=2, T=32: the card (bf16 activations through the tensor-
    core K1-K3) against the CPU (f32 activations through the plain
    versions) on the same f32 parameters, drawn on the card and copied to
    the host; heads with a nonzero second layer, so every group's gradient
    is nonzero. The states carry no optimizer state (one loss and its
    gradients are compared), and the 1.7B gradient elements are compared on
    the card: in float64 on the host that comparison took longer than the
    CPU step (4.1 against 1.3 s at d1024)."""
    cut = config.replace(num_layers=GPTJ_CPU_LAYERS)
    cpu_cfg = cut.replace(dtype="float32")
    card = _train_modules(cut, "cuda", seed=75, layer2_initializer_range=None)
    cpu_base = Transformer(cpu_cfg, device="cuda")
    cpu_base.load_state_dict(card[0].state_dict())
    cpu = [cpu_base.to("cpu")] + [copy.deepcopy(m).to("cpu") for m in card[1:]]
    batch = _train_batch("cpu", b=2, t=32, nt=8, seed=1)
    L = cut.num_layers
    runs = []
    for d, mods, cfg in (("cuda", card, cut), ("cpu", cpu, cpu_cfg)):
        state = init_ilql_state(*mods, set_to_zero(), set_to_zero(), ILQLConfig())
        _reset_counts()
        loss, _, grads = ilql_loss_and_grads(LMCore(cfg, device=d), state, ILQLBatch(*(x.to(d) for x in batch)),
                                             ILQLConfig(), PAD_ID)
        if d == "cuda":
            want = _want(L, fwd=3, bwd=1)
            check(_all_counts() == want, f"GPT-J card step: {_fmt_counts(_all_counts())}, want {want}")
        runs.append((loss.item(), [{k: g.float().cuda() for k, g in group.items()} for group in grads]))
        del state, grads
    _compare_card_cpu(f"GPT-J ILQL step at {L} layers", runs, ("base", "q1", "q2", "v"), "bf16", GPTJ_STEP_TOLS)


def phase_gptj_train() -> dict:
    """Phase 3jt: GPT-J-6B training at full width (`gptj_6b`'s d 4096, 16
    heads of Dh 256, rotary 64 interleaved, parallel FFN, untied lm_head,
    vocab 50,432), depth cut to GPTJ_TRAIN_LAYERS, f32 parameters from a
    seed with bf16 activations. The ILQL step at bench.py::
    bench_ilql_real_vocab's point (B=32, T=160, next window 16, separate
    target trunk, twin MLP Q heads and V head at hidden 8,192): one
    warm-up, GPTJ_TRAIN_REPS timed with exact launches worked out from the
    code before the run (per layer three K1 — trained, target and
    next-window trunks — and one K2 and K3: (18, 6, 6), all on the tensor
    cores), finite losses that move, updates/s, tokens/s, MFU by bench.py's
    count and peak memory, then one step profiled. Then, the heads, target
    trunk and optimizer state freed, GPTJ_BC_REPS BC steps at the Text-Nav
    window (B=8, T=640, loss on alternate tokens; (6, 6, 6) on the tensor
    cores), and the card-vs-CPU ILQL step at GPTJ_CPU_LAYERS layers."""
    config = gptj_config().replace(num_layers=GPTJ_TRAIN_LAYERS)
    L = config.num_layers
    core = LMCore(config)
    t0 = time.perf_counter()
    base, q1, q2, v = _train_modules(config, "cuda", seed=70)
    state = init_ilql_state(base, q1, q2, v, adamw(1e-4), adamw(1e-3), ILQLConfig())
    step = make_ilql_train_step(core, ILQLConfig(), PAD_ID)
    batch = _train_batch()
    torch.cuda.synchronize()
    n_base, n_head, n_v = port_bench.n_params(base), port_bench.n_params(q1), port_bench.n_params(v)
    log(f"GPT-J train setup (3jt): {L} of {gptj_config().num_layers} layers at full width, {n_base / 1e9:.3f}B trunk "
        f"parameters f32 (trained, Adam) + target copy, twin MLP Q heads ({2 * n_head / 1e9:.3f}B) and V head "
        f"trained, target Q heads; B={TRAIN_B} T={TRAIN_T} next={NEXT_T}, bf16 activations: "
        f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    t0 = time.perf_counter()
    state, loss, _ = step(state, batch)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(loss)), f"GPT-J warm-up ILQL loss {loss.item()}")
    log(f"GPT-J warm-up ILQL step: {time.perf_counter() - t0:.3f} s, loss {loss.item():.4f}")
    torch.cuda.reset_peak_memory_stats()
    want = _want(L, fwd=3, bwd=1)
    losses, times = [], []
    t_all = time.perf_counter()
    for i in range(GPTJ_TRAIN_REPS):
        _reset_counts()
        t0 = time.perf_counter()
        state, loss, logs = step(state, batch)
        times.append(time.perf_counter() - t0)  # the host's time in the step call
        counts = _all_counts()
        check(counts == want, f"GPT-J ILQL step {i}: {_fmt_counts(counts)}, want {want}")
        losses.append(loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t_all
    losses = torch.stack(losses).cpu()
    check(bool(torch.isfinite(losses).all()), f"GPT-J ILQL losses {losses.tolist()}")
    check(len(set(losses.tolist())) == len(losses), f"GPT-J ILQL losses do not move: {losses.tolist()}")
    flops = ilql_update_flops(config, TRAIN_B, TRAIN_T, NEXT_T, n_base, n_head, n_v)
    ups = GPTJ_TRAIN_REPS / dt
    log(f"GPT-J ILQL train: {GPTJ_TRAIN_REPS} steps in {dt:.4f} s: updates_per_s={ups:.4f} "
        f"tokens_per_s={ups * TRAIN_B * TRAIN_T:.1f} mfu={flops * ups / PEAK_FLOPS[torch.bfloat16]:.4f} "
        f"(bench.py's count {flops / 1e12:.3f} TFLOP per update over 989 TF/s) "
        f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"host_ms_per_step_call={1e3 * sum(times) / len(times):.1f}; per step {_fmt_counts(counts)}; "
        f"losses {[round(x, 4) for x in losses.tolist()]}; last logs q1_loss={logs['losses']['q1_loss'].item():.4f} "
        f"v_loss={logs['losses']['v_loss'].item():.4f} q1_cql={logs['losses']['q1_cql_loss'].item():.4f}")
    profile_run("GPT-J ILQL step", lambda: step(state, batch), dt / GPTJ_TRAIN_REPS)
    out = _path_counts("gptj_train_step", counts)

    trunk = state.base.params
    del state, step, base, q1, q2, v, logs, loss
    torch.cuda.empty_cache()
    bc_state = BCTrainState(TrainState(trunk, adamw(1e-4)))
    bc_step = make_bc_train_step(core, BCConfig(), PAD_ID)
    g = torch.Generator().manual_seed(71)
    ids = torch.randint(1, 256, (GPTJ_BC_B, TN_LEN), generator=g).cuda()
    training_mask = torch.zeros(GPTJ_BC_B, TN_LEN, dtype=torch.int32, device="cuda")
    training_mask[:, 2::2] = 1  # alternate tokens, as 3t's BC steps
    bc_batch = BCBatch(ids, training_mask)
    torch.cuda.reset_peak_memory_stats()
    want = _want(L, fwd=1, bwd=1)
    for i in range(GPTJ_BC_REPS):
        _reset_counts()
        t0 = time.perf_counter()
        bc_state, bc_loss, _ = bc_step(bc_state, bc_batch)
        torch.cuda.synchronize()
        counts = _all_counts()
        check(counts == want, f"GPT-J BC step {i}: {_fmt_counts(counts)}, want {want}")
        check(bool(torch.isfinite(bc_loss)), f"GPT-J BC loss {bc_loss.item()}")
        log(f"GPT-J BC step {i} B={GPTJ_BC_B} T={TN_LEN}: {time.perf_counter() - t0:.4f} s, loss {bc_loss.item():.4f}, "
            f"{_fmt_counts(counts)}, peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    out.update(_path_counts("gptj_bc_step", counts))
    del bc_state, bc_step, trunk
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _gptj_train_card_vs_cpu(config)
    log(f"GPT-J card-vs-CPU ILQL step at {GPTJ_CPU_LAYERS} layers: {time.perf_counter() - t0:.1f} s")
    return out



# ---------------- slice 15: K4's split route ----------------

SPLIT_T_MAX = 832  # 2s: the caches of the split checks (the f32 dialog policy's 768 + 48, rounded up)
SPLIT_INDICES = (127, 128, 300, 791)  # 2 splits of 64; of 64 and 65; up to 4 of ~75; up to 12 of ~66
SPLIT_MAX_PAD = 300  # left padding up to 300 keys: longer than a split at every checked B x H


# 3a: configs whose attention the kernels refuse, at GPT-2-small's width cut
# to 2 layers: a head dim of 28 (hidden 224 over 8 heads; f32 on both sides,
# held to the f32 step tolerance) and float16 activations (Dh = 64; the CPU
# runs f32, held to LOGIT_TOL as the bf16 card runs are)
ROUTE_CASES = (("Dh 28", dict(hidden_size=224, num_heads=8, dtype="float32"), 1e-4),
               ("float16", dict(dtype="float16"), LOGIT_TOL))
ROUTE_B, ROUTE_PROMPT, ROUTE_T_MAX = 4, 48, 64


def _route_run(model, cfg, device, ids, mask, pos) -> tuple:
    """A no-cache forward, then a cached left-padded prefill, three 1-token
    steps and an 8-token append, each with its counts (einsum calls, K1-K4
    launches): (logits of each call, counts of each call)."""
    ids, mask, pos = ids.to(device), mask.to(device), pos.to(device)
    full = torch.zeros(ROUTE_B, ROUTE_T_MAX, dtype=mask.dtype, device=device)
    full[:, :ids.shape[1]] = mask
    cache = KVCache.init(cfg, ROUTE_B, ROUTE_T_MAX, device=device)
    logits, counts = [], []

    def call(*args, **kw):
        attention_einsum.calls = 0
        _reset_counts()
        out = model(*args, **kw)
        _sync(device)
        counts.append((attention_einsum.calls, flash_fwd.launches, decode_attention.launches))
        logits.append(out[0].float().cpu())
        return out

    with torch.inference_mode():
        call(ids, attention_mask=mask, position_ids=pos)
        start = 0
        for T in (ROUTE_PROMPT, 1, 1, 1, 8):
            _, _, cache = call(ids[:, start:start + T], attention_mask=full, position_ids=pos[:, start:start + T],
                               cache=cache)
            start += T
    attention_einsum.calls = 0
    return logits, counts


def phase_attention_route(device="cuda") -> None:
    """The attention route of configs the kernels refuse (a head dim or a
    dtype they do not take; the JAX model's einsum route runs them).
    Each ROUTE_CASES model takes the einsum route on every call (no-cache
    forward, cached prefill, 1-token steps, append: L einsum calls each, no
    K1 or K4 launch) on the card and matches the CPU at real positions;
    the Dh = 28 model's no-cache training gradient (plain autograd through
    the einsum route, no K2/K3 launch) matches the CPU's within
    STEP_GRAD_RTOL. The wrappers, called directly, still refuse both."""
    n = ROUTE_PROMPT + 3 + 8
    rng = np.random.default_rng(16)
    ids = torch.from_numpy(rng.integers(0, 50257, (ROUTE_B, n))).long()
    mask = (torch.arange(n)[None, :] >= torch.tensor([0, 3, 17, 40])[:, None]).int()
    pos = (mask.cumsum(1) - 1).clamp(min=0)
    real = mask.bool()
    for name, kw, tol in ROUTE_CASES:
        cfg = gpt2_small().replace(num_layers=2, embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, **kw)
        check(not kernels_take(cfg.head_dim, torch_dtype(cfg.dtype)), f"{name}: the kernels take Dh {cfg.head_dim}")
        card = init_params(cfg, seed=16, device=device)
        cpu_cfg = cfg.replace(dtype="float32")
        cpu = Transformer(cpu_cfg, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
        t0 = time.perf_counter()
        got, counts = _route_run(card, cfg, device, ids, mask, pos)
        seconds = time.perf_counter() - t0
        ref, cpu_counts = _route_run(cpu, cpu_cfg, "cpu", ids, mask, pos)
        want = [(cfg.num_layers, 0, 0)] * len(counts)
        check(counts == want, f"3a {name}: (einsum, K1, K4) per call {counts}, want {want}")
        spans, err = [0, *np.cumsum([ROUTE_PROMPT, 1, 1, 1, 8]).tolist()], 0.0
        for i, (g, r) in enumerate(zip(got, ref)):
            rows = real if i == 0 else real[:, spans[i - 1]:spans[i]]
            diff = ((g - r).abs() - tol * r.abs())[rows].max().item()
            err = max(err, (g - r).abs()[rows].max().item())
            check(diff <= tol, f"3a {name}: call {i} card vs CPU logits differ by {(g - r).abs()[rows].max().item()} "
                               f"(atol, rtol {tol})")
        line = (f"phase 3a {name} (Dh {cfg.head_dim}, {cfg.dtype}, L={cfg.num_layers}): card vs CPU ({cpu_cfg.dtype}; "
                f"CPU route (einsum, K1, K4) {cpu_counts[0]}) max logit diff {err:.3e} (atol, rtol {tol}) over a "
                f"no-cache forward, a prefill of {ROUTE_PROMPT}, 3 steps and an append of 8 (B={ROUTE_B}, left-padded); "
                f"per call (einsum, K1, K4) {counts[0]}; card {seconds:.2f} s")
        if cfg.dtype == "float32":
            w = torch.randn(ROUTE_B, n, cfg.padded_vocab_size, generator=torch.Generator().manual_seed(3))
            grads = []
            for model, dev in ((card, device), (cpu, "cpu")):
                attention_einsum.calls = 0
                _reset_counts()
                logits = model(ids.to(dev), attention_mask=mask.to(dev), position_ids=pos.to(dev))[0]
                params = [p for p in model.parameters() if p.requires_grad]
                g = torch.autograd.grad((logits * w.to(dev)).sum(), params)
                _sync(dev)
                check((attention_einsum.calls, flash_fwd.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches)
                      == (cfg.num_layers, 0, 0, 0), f"3a {name} training forward: route counts")
                grads.append([x.cpu() for x in g])
            attention_einsum.calls = 0
            rel = max(((a - b).norm() / b.norm().clamp(min=1e-30)).item() for a, b in zip(*grads))
            check(rel <= STEP_GRAD_RTOL, f"3a {name}: card vs CPU gradient relative error {rel}")
            line += f"; training gradient card vs CPU max relative norm error {rel:.3e} (tol {STEP_GRAD_RTOL})"
        log(line)
        del card
    # called directly, the wrappers refuse what the route sends elsewhere
    q28 = torch.zeros(1, 2, 4, 28, device=device)
    h16 = torch.zeros(1, 2, 4, 64, device=device, dtype=torch.float16)
    for args, exc in (((q28, q28, q28), ValueError), ((h16, h16, h16), TypeError)) if device == "cuda" else ():
        try:
            flash_fwd(*args)
        except exc:
            continue
        raise SmokeFailure(f"flash_fwd took {args[0].dtype} Dh={args[0].shape[-1]}")
    _check_no_einsum("3a")


def _split_inputs(b, h, dh, t_max, index, dtype, gen, max_pad):
    """q [b,h,1,dh], a [b,h,t_max,dh] cache and a left-pad bias whose first
    row masks min(index, max_pad) keys (longer than a split, so whole
    splits of that row see masked keys only); key `index` stays visible."""
    q = torch.randn(b, h, 1, dh, device="cuda", generator=gen).to(dtype)
    k = torch.randn(b, h, t_max, dh, device="cuda", generator=gen).to(dtype)
    v = torch.randn(b, h, t_max, dh, device="cuda", generator=gen).to(dtype)
    n_pad = torch.randint(0, min(index, max_pad) + 1, (b,), device="cuda", generator=gen)
    n_pad[0] = min(index, max_pad)
    bias = torch.where(torch.arange(t_max, device="cuda")[None, :] >= n_pad[:, None], 0.0, _NEG_BIG).float()
    return q, k, v, bias


def _decode_row(label, b, h, dh, indices, t_max, dtype, gen, max_pad, reps=20) -> dict:
    """K4 at `indices` of one path's shape, each launch checked against the
    plain version on the route `_decode_splits` picks; per-launch means of
    the kernel's, plain version's and SDPA's ms, the bound (bytes with the
    bias) and the split count."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    scale = dh**-0.5
    rows = []
    for index in indices:
        q, k, v, bias = _split_inputs(b, h, dh, t_max, index, dtype, gen, max_pad)
        err = _check_decode(q, k, v, index, bias, dtype, f"{label} index={index}")
        n = index + 1
        kn, vn, mask = k[:, :, :n], v[:, :, :n], (bias[:, :n] == 0)[:, None, None, :]
        n_bytes, flops = decode_work(b, h, dh, n, dtype)
        row = dict(ms=cuda_ms(lambda: decode_attention(q, k, v, index, bias, scale), reps),
                   plain_ms=cuda_ms(lambda: _plain_decode_attention(q, k, v, index, bias, scale), 5, 1),
                   library_ms=cuda_ms(lambda: sdpa(q, kn, vn, attn_mask=mask, scale=scale), reps),
                   splits=_decode_splits(b, h, dh, n, _device_sms(q.device)))
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes + 4 * b * n, flops, dtype)
        rows.append(dict(row, err=err))
    mean = _mean_rows(rows)
    log(f"time decode_attn {label} B={b} H={h} Dh={dh} {str(dtype)[6:]} indices {indices[0]}..{indices[-1]} "
        f"({len(indices)} launches, mean per launch): " + " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in mean.items())
        + f" bound_share={mean['bound_ms'] / mean['ms']:.3f}")
    return mean


def phase_split_checks() -> tuple:
    """Phase 2s: K4's split route (Dh <= 128 below two blocks per SM, keys
    cut into splits merged in one launch) against its plain version, f32
    and bf16, at Dh 32, 48, 64 and 128, B x H from 1 to one below the
    threshold (2 x SMs), indices across split boundaries, and left padding
    longer than a split; then its times at a served Text-Nav turn
    (GPT-2-small, B=16, bf16, fills 640..675) and a text-env turn's decode
    (B=8, bf16, fills 128..137), each beside its bound, plain and SDPA.
    Returns the max error and the two rows."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    n_sms = _device_sms(torch.device("cuda"))
    err, n_checks, split0 = 0.0, 0, decode_attention.split_launches
    for dtype in (torch.float32, torch.bfloat16):
        for dh in (32, 48, 64, 128):
            for b, h in ((1, 1), (1, 4), (4, H), (16, 4), (16, H), (2 * n_sms - 1, 1)):
                for index in SPLIT_INDICES:
                    q, k, v, bias = _split_inputs(b, h, dh, SPLIT_T_MAX, index, dtype, gen, SPLIT_MAX_PAD)
                    err = max(err, _check_decode(q, k, v, index, bias, dtype,
                                                 f"split route B={b} H={h} Dh={dh} index={index}"))
                    n_checks += 1
    n_split = decode_attention.split_launches - split0
    check(n_split == n_checks, f"split route checks: {n_split} of {n_checks} launches on the split route")
    log(f"check decode_attn split route (2s): {n_checks} launches (f32, bf16; Dh 32, 48, 64, 128; B x H 1 .. "
        f"{2 * n_sms - 1}; indices {SPLIT_INDICES}; left padding up to {SPLIT_MAX_PAD} keys), all on the split "
        f"route, max_abs_err={err:.3e} (atol, rtol f32 {TOL[torch.float32]}, bf16 {TOL[torch.bfloat16]})")
    rows = {"text_nav_turn": _decode_row("Text-Nav turn", 16, H, DH, list(range(TN_LEN, TN_LEN + TN_NEW, 3)),
                                         TN_LEN + TN_NEW, torch.bfloat16, gen, TN_LEN - 1),
            "text_env_turn": _decode_row("text-env turn", 8, H, DH, list(range(T_MAX, T_MAX + 10)), T_MAX + 10,
                                         torch.bfloat16, gen, T_MAX - 1)}
    err = max([err] + [r["err"] for r in rows.values()])
    return err, rows


# ---------------- slice 14: runs that repeat ----------------

# 3q's kernel reruns: every variant and route of K1-K4 launched twice on the
# same inputs, at a serving shape and a training shape each (K2 and K3 run
# only in training: two training shapes). K1 (label, dtype, b, h, dh, Tq, S,
# left-padded): the Wordle rollout's appends and the ILQL step's windows on
# the tensor cores, GPT-J's rollout appends and ILQL windows on the wide
# kernel, the f32 dialog gates' policy prefill and 20Q windows on the CUDA
# cores
RERUN_FWD_CASES = (
    ("tc serving", torch.bfloat16, B, H, DH, 10, T_MAX, False),
    ("tc training", torch.bfloat16, TRAIN_B, H, DH, TRAIN_T, TRAIN_T, True),
    ("wide serving", torch.bfloat16, GPTJ_B, GPTJ_H, GPTJ_DH, 10, T_MAX, False),
    ("wide training", torch.bfloat16, TRAIN_B, GPTJ_H, GPTJ_DH, TRAIN_T, TRAIN_T, False),
    ("simt serving", torch.float32, 16, 4, 64, DIALOG_MAX_LEN, DIALOG_MAX_LEN, True),
    ("simt oracle", torch.float32, 16, 4, 32, ORACLE_INPUT, ORACLE_INPUT, True),
    ("simt training", torch.float32, TRAIN_B, H, DH, TRAIN_T, TRAIN_T, True),
)
# K2 and K3 (label, dtype, b, h, dh, Tq, S, padding): the ILQL step and the
# Text-Nav PPO windows on the tensor cores, GPT-J's ILQL step and BC window
# on the wide kernels, the f32 card step's point and the 20Q policy's windows
# on the CUDA cores
RERUN_BWD_CASES = (
    ("tc", torch.bfloat16, TRAIN_B, H, DH, TRAIN_T, TRAIN_T, True),
    ("tc", torch.bfloat16, TRAIN_B, H, DH, TN_LEN, TN_LEN, "right"),
    ("wide", torch.bfloat16, TRAIN_B, GPTJ_H, GPTJ_DH, TRAIN_T, TRAIN_T, False),
    ("wide", torch.bfloat16, GPTJ_BC_B, GPTJ_H, GPTJ_DH, TN_LEN, TN_LEN, True),
    ("simt", torch.float32, TRAIN_B, H, DH, TRAIN_T, TRAIN_T, True),
    ("simt", torch.float32, 16, 4, 64, DIALOG_MAX_LEN, DIALOG_MAX_LEN, "right"),
)
# K4 (label, dtype, b, h, dh, cache slots, index): the Wordle rollout; GPT-J's
# rollout (B·H = 4,096: the common route) and Text-Nav turn (B·H = 256: the
# Dh > 128 route); the f32 decoder oracle's fidelity probe; the split route
# at the f32 dialog policy's last slot (B·H = 64) and a GPT-2-small Text-Nav
# turn's (B·H = 192)
RERUN_DECODE_CASES = (
    ("serving", torch.bfloat16, B, H, DH, T_MAX, 67),
    ("Dh 256, common route", torch.bfloat16, GPTJ_B, GPTJ_H, GPTJ_DH, T_MAX, 100),
    ("Dh 256, own route", torch.bfloat16, GPTJ_TURN_B, GPTJ_H, GPTJ_DH, TN_LEN + TN_NEW, TN_LEN + TN_NEW - 1),
    ("f32", torch.float32, 100, 4, 32, ORACLE_INPUT + ORACLE_NEW, ORACLE_INPUT + ORACLE_NEW - 1),
    ("split f32", torch.float32, 16, 4, 64, DIALOG_MAX_LEN + DIALOG_NEW, DIALOG_MAX_LEN + DIALOG_NEW - 1),
    ("split bf16", torch.bfloat16, 16, H, DH, TN_LEN + TN_NEW, TN_LEN + TN_NEW - 1),
)
RERUN_ILQL_STEPS = 3  # 3q: ILQL steps at 3t's point from one seed, run twice
RERUN_T5_WINDOWS = 32  # 3q: two B=16 steps of the T5 oracle trainer


def _same(label: str, first: list, second: list) -> None:
    """Two runs' tensors equal to the bit (torch.equal, no tolerance)."""
    check(len(first) == len(second), f"rerun {label}: {len(first)} against {len(second)} tensors")
    for i, (a, b) in enumerate(zip(first, second)):
        if not torch.equal(a, b):
            d = (a.float() - b.float()).abs().max().item() if a.shape == b.shape else f"shapes {a.shape}, {b.shape}"
            raise SmokeFailure(f"rerun {label}: tensor {i} of {len(first)} differs between two runs (max |diff| {d})")


def _state_tensors(state) -> list:
    """Copies of every parameter of a train state's modules (trained and
    target), in field order."""
    out = []
    for f in dataclasses.fields(state):
        x = getattr(state, f.name)
        module = x.params if isinstance(x, TrainState) else x
        if isinstance(module, torch.nn.Module):
            out += [p.detach().clone() for p in module.parameters()]
    return out


def _rerun_kernels() -> int:
    """Each kernel variant and route launched twice on the same inputs;
    returns the number of (case, launch pair)s held equal."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    n = 0
    for label, dtype, b, h, dh, Tq, S, padded in RERUN_FWD_CASES:
        q, k, v, bias = _flash_inputs(Tq, S, dtype, padded, gen, b=b, h=h, dh=dh)
        tc0 = flash_fwd.tc_launches
        runs = [list(flash_fwd(q, k, v, bias, True, dh**-0.5)) for _ in range(2)]
        check((flash_fwd.tc_launches - tc0 == 2) == (label.split()[0] != "simt"),
              f"rerun flash_fwd {label}: {flash_fwd.tc_launches - tc0} tensor-core launches of 2")
        _same(f"flash_fwd {label} B={b} H={h} Dh={dh} Tq={Tq} S={S}", *runs)
        n += 1
    for label, dtype, b, h, dh, Tq, S, padded in RERUN_BWD_CASES:
        args, _, _ = _bwd_inputs(Tq, S, dtype, padded, gen, b, h, dh)
        tc0 = _tc_counts()
        runs = [[flash_bwd_dq(*args, True, dh**-0.5), *flash_bwd_dkv(*args, True, dh**-0.5)] for _ in range(2)]
        want_tc = (2, 2) if label != "simt" else (0, 0)
        check(tuple(x - y for x, y in zip(_tc_counts(), tc0)) == want_tc, f"rerun flash_bwd {label}: tensor-core launches")
        _same(f"flash_bwd_dq/dkv {label} B={b} H={h} Dh={dh} T={Tq} padding={padded}", *runs)
        n += 1
    for label, dtype, b, h, dh, t_max, index in RERUN_DECODE_CASES:
        q, k, v, bias = _decode_inputs(index, dtype, True, gen, b=b, h=h, t_max=t_max, dh=dh)
        split0 = decode_attention.split_launches
        runs = [[decode_attention(q, k, v, index, bias, dh**-0.5)] for _ in range(2)]
        check((decode_attention.split_launches - split0 == 2) == label.startswith("split"),
              f"rerun decode_attn {label}: {decode_attention.split_launches - split0} split-route launches of 2")
        _same(f"decode_attn {label} B={b} H={h} Dh={dh} index={index}", *runs)
        n += 1
    torch.cuda.synchronize()
    return n


def _rerun_ilql(config, device="cuda") -> list:
    """RERUN_ILQL_STEPS ILQL steps at 3t's point (seeded modules, bench.py's
    batch): the losses, then every parameter of the state."""
    modules = _train_modules(config, device)
    state = init_ilql_state(*modules, adamw(1e-4), adamw(1e-3), ILQLConfig())
    step = make_ilql_train_step(LMCore(config, device=device), ILQLConfig(), PAD_ID)
    batch = _train_batch(device)
    losses = []
    for _ in range(RERUN_ILQL_STEPS):
        state, loss, _ = step(state, batch)
        losses.append(loss.reshape(1))
    return [torch.cat(losses)] + _state_tensors(state)


def _rerun_ppo(config, batch, device="cuda") -> list:
    """3p's first PPO step (no BC term) from 3p's seeded policy and value
    head, on 3p's first batch: the loss, then every parameter."""
    policy = init_params(config, seed=20, device=device)
    value_head = LinearHead(LinearHeadConfig(config.hidden_size, 1), device=device, seed=21)
    state = PPOTrainState(TrainState(policy, adamw(1e-5)), TrainState(value_head, adamw(1e-4)))
    step = make_ppo_train_step(LMCore(config, device=device), PPOConfig(gamma=0.99, lam=0.95, bc_loss_weight=0.0),
                               ByteTokenizer().pad_token_id)
    state, loss, _ = step(state, batch)
    return [loss.reshape(1)] + _state_tensors(state)


def _rerun_t5(device="cuda") -> list:
    """Two B=16 steps of `lm_oracle.train_t5_oracle_lm` at 3d's check width
    (d2048, 32 heads, 2 + 2 layers) over the 20Q task BPE: every parameter."""
    windows = lm_oracle.COLLECTORS["twenty_questions"](8, 0)[:RERUN_T5_WINDOWS]
    check(len(windows) == RERUN_T5_WINDOWS, f"rerun T5: {len(windows)} oracle windows")
    cfg = lm_oracle.OracleTrainConfig(epochs=1, train_bsize=16, hidden_size=flan_t5_xl().d_model,
                                      num_layers=2 * T5_CHECK_LAYERS, num_heads=flan_t5_xl().num_heads)
    _, _, params, _ = lm_oracle.train_t5_oracle_lm(windows, cfg, tokenizer=dialog_tokenizer(), log=lambda _: None,
                                                   device=device)
    return [p.detach().clone() for p in params.parameters()]


def phase_rerun(config, ppo_config, ppo_batch, chess_result: dict) -> None:
    """Phase 3q: a seeded run gives the same bits twice. Every kernel
    variant and route launched twice on the same inputs; 3t's ILQL steps,
    3p's first PPO step and two T5 oracle-trainer steps each run twice from
    their seeds; and 3h's cut chess gate run again in a subprocess whose
    PYTHONHASHSEED differs from this process's, its result JSON held to
    3h's key for key. Every comparison is exact."""
    t0 = time.perf_counter()
    n = _rerun_kernels()
    log(f"rerun kernels (3q): {n} cases, each two launches bitwise equal, {time.perf_counter() - t0:.2f} s")
    for name, run in (("ILQL", lambda: _rerun_ilql(config)), ("PPO", lambda: _rerun_ppo(ppo_config, ppo_batch)),
                      ("T5 oracle", _rerun_t5),
                      ("Wordle gate's JAX stream", lambda: list(_stream_draws("cuda").values()))):
        t0 = time.perf_counter()
        first = run()
        second = run()
        torch.cuda.synchronize()
        _same(name, first, second)
        log(f"rerun {name} (3q): {len(first)} tensors bitwise equal over two runs, {time.perf_counter() - t0:.1f} s")
        del first, second
        torch.cuda.empty_cache()
    hash_seed = str(int(os.environ.get("PYTHONHASHSEED", "0")) + 1)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "lmrl_gym_torch.scripts.chess_ilql_gate", *CHESS_GATE_ARGS],
                          env=dict(os.environ, PYTHONHASHSEED=hash_seed), capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"rerun chess gate: the subprocess exited {proc.returncode}: {proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    again = json.loads(lines[-1])
    check(again == chess_result, f"rerun chess gate (PYTHONHASHSEED={hash_seed}): {again} against 3h's {chess_result}")
    log(f"rerun chess gate (3q): a subprocess at PYTHONHASHSEED={hash_seed} gave 3h's result key for key "
        f"({len(again)} keys), {time.perf_counter() - t0:.1f} s ({lines[-2]}; the rest its start-up)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on the card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    cpu_count = None
    try:
        card = phase_device()
        log(f"phase 1: {time.perf_counter() - t_start:.1f} s")
        cpu_count = start_cpu_count()
        t0 = time.perf_counter()
        errs = phase_kernel_checks()
        log(f"phase 2 serving shapes: {time.perf_counter() - t0:.1f} s")
        t1 = time.perf_counter()
        bwd_errs, gptj_bwd = phase_bwd_checks()
        log(f"phase_bwd_checks: {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        path_errs, dialog_f32 = phase_path_checks()
        log(f"phase_path_checks: {time.perf_counter() - t1:.1f} s")
        for name, err in list(bwd_errs.items()) + list(path_errs.items()):
            errs[name] = max(errs.get(name, 0.0), err)
        t1 = time.perf_counter()
        gptj_shapes = phase_gptj_kernel_checks()
        for name in ("flash_fwd", "decode_attn"):
            errs[name] = max(errs[name], *(gptj_shapes[f"{name}_{path}"]["err"] for path in ("gptj_rollout", "gptj_turn")))
        errs["flash_fwd"] = max(errs["flash_fwd"], gptj_shapes["flash_fwd_gptj_train_step"]["err"])
        log(f"phase 2j (GPT-J, Dh=256): {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        split_err, split_rows = phase_split_checks()
        errs["decode_attn"] = max(errs["decode_attn"], split_err)
        log(f"phase 2s (K4's split route): {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        shapes = phase_main_path_shapes()
        shapes.update(phase_train_shapes())
        log(f"main-path and train-step shape timings: {time.perf_counter() - t1:.1f} s")
        log(f"phases 2, 2p: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches = phase_slice()
        log(f"phase 3: {time.perf_counter() - t0:.1f} s")
        t1 = time.perf_counter()
        b3 = phase_bench(cpu_count)
        launches.update(phase_train(launches["config"], b3.pop("train_steps"), b3.pop("train_result")))
        launches.update(b3)
        log(f"phases 3b, 3k, 3t: {time.perf_counter() - t1:.1f} s")
        t0 = time.perf_counter()
        launches.update(phase_online(launches["config"]))
        launches.update(phase_gate())
        launches.update(phase_gate_stream())
        launches.update(phase_text_env(launches["serving"], launches["config"]))
        log(f"phases 3o, 3g, 3s: {time.perf_counter() - t0:.1f} s")
        t_slice6 = time.perf_counter()
        launches.update(phase_mc(launches["config"]))
        launches.update(phase_cql(launches["config"]))
        ppo = phase_ppo()
        ppo_batch, ppo_config = ppo.pop("batch"), ppo.pop("config")
        launches.update(phase_rerank(ppo.pop("policy"), ppo_config))
        launches.update(ppo)
        launches.update(phase_maze_gate())
        log(f"phases 3m, 3c, 3p, 3r, 3z: {time.perf_counter() - t_slice6:.1f} s")
        t_slice7 = time.perf_counter()
        launches.update(phase_text_nav_ppo())
        launches.update(phase_loops(launches["config"]))
        launches.update(phase_ppo_gates())
        log(f"phases 3n, 3l, 3w: {time.perf_counter() - t_slice7:.1f} s")
        t_slice8 = time.perf_counter()
        for name, phase in (("3u", phase_online_markov), ("3h", phase_chess_gate)):
            t0 = time.perf_counter()
            launches.update(phase())
            log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        log(f"phases 3u, 3h: {time.perf_counter() - t_slice8:.1f} s")
        t0 = time.perf_counter()
        phase_rerun(launches["config"], ppo_config, ppo_batch, launches.pop("chess_gate_result"))
        log(f"phase 3q: {time.perf_counter() - t0:.1f} s")
        t_slice9 = time.perf_counter()
        for name, phase in (("3d", phase_dialog), ("3e", phase_dialog_gates)):
            t0 = time.perf_counter()
            launches.update(phase())
            log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        log(f"phases 3d, 3e: {time.perf_counter() - t_slice9:.1f} s")
        t0 = time.perf_counter()
        launches.update(phase_cli())
        log(f"phase 3i: {time.perf_counter() - t0:.1f} s")
        launches.update(phase_sharded(launches["config"]))
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        launches.update(phase_gptj())
        log(f"phase 3j: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        launches.update(phase_gptj_train())
        log(f"phase 3jt: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_card_vs_cpu(launches["base"], launches["config"])
        log(f"phase 4 serving: {time.perf_counter() - t0:.1f} s")
        phase_train_card_vs_cpu(launches["config"])
        log(f"phase 4: {time.perf_counter() - t0:.1f} s")
        _check_no_einsum("every path")
        t0 = time.perf_counter()
        phase_attention_route()
        log(f"phase 3a: {time.perf_counter() - t0:.1f} s")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if cpu_count is not None and cpu_count.poll() is None:
            cpu_count.kill()
            cpu_count.wait()
    replaces = {
        "flash_fwd": "lmrl_gym_tpu/ops/flash_attention.py:59",
        "flash_bwd_dq": "lmrl_gym_tpu/ops/flash_attention.py:182",
        "flash_bwd_dkv": "lmrl_gym_tpu/ops/flash_attention.py:229",
        "decode_attn": "lmrl_gym_tpu/ops/decode_attention.py:83",
    }
    # both main paths run K1, K2 and K3 on the tensor-core variant (bf16,
    # Dh=64), and so do GPT-J's paths at Dh=256 (3j: K1; 3jt: K1-K3, each
    # source's wide kernels); csrc/flash_fwd.cu and csrc/flash_bwd.cu keep f32
    source = {"flash_fwd": "flash_fwd_tc", "flash_bwd_dq": "flash_bwd_tc", "flash_bwd_dkv": "flash_bwd_tc",
              "decode_attn": "decode_attn"}
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": f"lmrl_gym_torch/csrc/{source[name]}.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": shapes[name]["ms"],
            "plain_ms": shapes[name]["plain_ms"],
            "bound_ms": shapes[name]["bound_ms"],
            "bound_by": shapes[name]["bound_by"],
            "library_ms": shapes[name]["library_ms"],
        }
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "decode_attn")
    ]
    # flash_fwd runs on both paths: its serving row above, its train step here
    train_fwd = shapes["flash_fwd_train_step"]
    kernels[0].update(variant="tc", tc_launches=launches["flash_fwd_tc"],
                      launches_train_step=launches["flash_fwd_train_step"],
                      tc_launches_train_step=launches["flash_fwd_tc_train_step"], ms_train_step=train_fwd["ms"],
                      plain_ms_train_step=train_fwd["plain_ms"], bound_ms_train_step=train_fwd["bound_ms"],
                      bound_by_train_step=train_fwd["bound_by"], library_ms_train_step=train_fwd["library_ms"],
                      simt_ms=shapes["flash_fwd"]["simt_ms"], simt_ms_train_step=train_fwd["simt_ms"])
    for entry in kernels[1:3]:
        name = entry["name"]
        entry.update(variant="tc", tc_launches=launches[f"{name}_tc"], delta_ms=shapes[name]["delta_ms"],
                     pair_plus_delta_ms=shapes[name]["pair_plus_delta_ms"])
    # each kernel's launches on the later paths
    for entry in kernels:
        for path in ("online_round", "online_step", "gate", "text_env_turn", "mc_step", "cql_step", "ppo_step",
                     "ppo_step_bc", "ppo_forward", "ppo_rollout_turn", "score_call", "score_call_ilql_pi_beta",
                     "score_call_mc", "maze_gate_cql", "maze_gate_mc", "text_nav_turn", "ppo_forward_text_nav",
                     "ppo_step_text_nav", "ppo_step_text_nav_bc", "offline_loop_step", "online_loop_step",
                     "ppo_gate_text_nav", "ppo_gate_maze", "markov_maze", "markov_chess", "markov_guided",
                     "online_markov_round", "online_markov_step", "chess_gate", "dialog_asker_turn",
                     "dialog_oracle_turn", "dialog_gate_car_dealer", "dialog_gate_dialog_ilql",
                     "dialog_gate_twenty_questions", "cli_train", "cli_evaluate", "sharded_step", "gptj_rollout",
                     "gptj_turn", "gptj_train_step", "gptj_bc_step"):
            if f"{entry['name']}_{path}" in launches:
                entry[f"launches_{path}"] = launches[f"{entry['name']}_{path}"]
            if f"{entry['name']}_tc_{path}" in launches:
                entry[f"tc_launches_{path}"] = launches[f"{entry['name']}_tc_{path}"]
    # K1 and K4 at GPT-J's Dh=256 (2j's per-launch means over 3j's launches),
    # and K1 at 3jt's ILQL-step windows
    for entry in (kernels[0], kernels[3]):
        for path in ("gptj_rollout", "gptj_turn"):
            row = gptj_shapes[f"{entry['name']}_{path}"]
            entry.update({f"{k}_{path}": v for k, v in row.items() if k != "err"})
    kernels[0].update({f"{k}_gptj_train_step": v for k, v in gptj_shapes["flash_fwd_gptj_train_step"].items()
                       if k != "err"})
    # K4's split route: its launches on the main path (R: none, checked in
    # phase 3, as J's and Jt's in 3j) and on each later path, and 2s's times
    # at a Text-Nav turn and a text-env turn
    decode = kernels[3]
    decode["split_launches"] = launches["decode_attn_split"]
    for key in sorted(launches):
        if key.startswith("decode_attn_split_"):
            decode[f"split_launches_{key[len('decode_attn_split_'):]}"] = launches[key]
    decode["split_launches_all_paths"] = sum(v for k, v in decode.items() if k.startswith("split_launches"))
    for path, row in split_rows.items():
        decode.update({f"{k}_{path}": v for k, v in row.items() if k != "err"})
    # K2 and K3 at GPT-J's Dh=256 (phase 2's rows at 3jt's ILQL-step and BC-window shapes;
    # library = SDPA's backward of the pair, simt = the CUDA-core route they replaced)
    for entry, kind in ((kernels[1], "dq"), (kernels[2], "dkv")):
        for path, row in gptj_bwd.items():
            entry.update({f"ms_{path}": row[f"{kind}_ms"], f"plain_ms_{path}": row[f"plain_{kind}_ms"],
                          f"bound_ms_{path}": row[f"bound_{kind}_ms"], f"bound_by_{path}": row[f"bound_{kind}_by"],
                          f"library_ms_{path}": row["library_bwd_ms"], f"simt_ms_{path}": row[f"simt_{kind}_ms"]})
    # every f32 dialog-gate launch takes the CUDA-core variants (2p's f32 timings);
    # f32_dialog_loss_ms ranks the kernels for a redesign: the cut gates'
    # launches (3e) times the mean excess over the bound at 2p's f32 shapes
    for entry in kernels:
        entry["f32_dialog"] = [{k: v for k, v in row.items() if k != "kernel"}
                               for row in dialog_f32 if row["kernel"] == entry["name"]]
        rows = entry["f32_dialog"]
        gate_launches = sum(entry.get(f"launches_dialog_gate_{g}", 0)
                            for g in ("car_dealer", "dialog_ilql", "twenty_questions"))
        entry["f32_dialog_loss_ms"] = gate_launches * sum(r["ms"] - r["bound_ms"] for r in rows) / max(1, len(rows))
    log("f32 dialog ranking (cut gates' launches x mean (kernel - bound) ms at 2p's f32 shapes): " + ", ".join(
        f"{e['name']} {e['f32_dialog_loss_ms']:.2f}" for e in sorted(kernels, key=lambda e: -e["f32_dialog_loss_ms"])))
    log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
