"""The port's benchmark suite: the counterpart of `bench.py`. Prints ONE
JSON line with the keys of every section it ran, letter for letter the JAX
bench's:

    python -m lmrl_gym_torch.scripts.bench                     # all six, on the card
    BENCH_MODE=ilql python -m lmrl_gym_torch.scripts.bench     # one section
    BENCH_MODE=env python -m lmrl_gym_torch.scripts.bench --device cpu

Sections (each the JAX section's operating point, its sizes and reps
defaults; the JAX bench's environment variables `BENCH_BATCH`,
`BENCH_SEQ`, `BENCH_REPS` and `BENCH_SERVE_F32` fill them in `main`):

- `bench_ilql` (bench.py:60): the ILQL train step at d768 L12 H12 over the
  byte vocab (259 padded to 320), twin MLP Q heads and a V head (hidden
  1536, second layer zero), a separate target base, AdamW, B=32, T=160,
  a next window of 16; updates/s, tokens/s and the analytic MFU;
- `bench_actor` (:177): the fused Wordle actor, GPT-2-small over a
  512-token vocab, bf16 weights, B=512; env-steps/s and tokens/s;
- `bench_ilql_real_vocab` (:232): `bench_ilql` at GPT-2's 50,257 ids;
- `bench_actor_real_vocab` (:346): `bench_actor` at 50,257 ids;
- `bench_actor_markov` (:398): `rollout_markov` on the maze and the chess
  endgame, 8 turns, B=512, bf16 weights; env-steps/s per env;
- `bench_env` (:462): `WordleVectorEnv.rollout_episodes`, B=8,192: the
  headline keys `metric` / `value` / `unit` / `vs_baseline`.

Every timed window ends at a value fetch after `torch.cuda.synchronize()`,
as the JAX window ends at `float(loss)`. "Per chip" keys are per card: one
process drives one card. Weights are drawn from seeded `torch.Generator`s;
the ILQL batches are the JAX bench's own numpy draws.

What has no counterpart, and why:
- the budget guard (bench.py:524-543) and the `except Exception` records
  (:544-551): a section that fails raises and the run exits non-zero, and
  none is skipped, since a skipped or swallowed section would hide exactly
  what a benchmark must show;
- `_enable_compile_cache` (:28): an XLA setting; nothing is compiled here
  but the kernels, which `ops/_build.py` builds once per process.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from lmrl_gym_torch.algos import ilql
from lmrl_gym_torch.core.device import DeviceLike, resolve_device
from lmrl_gym_torch.core.optimizer import adamw
from lmrl_gym_torch.envs.chess.vector import ChessEndgameVectorEnv
from lmrl_gym_torch.envs.maze.grids import DOUBLE_T_GOAL, double_t_maze
from lmrl_gym_torch.envs.maze.vector import MazeTokenVecEnv, MazeVectorEnv
from lmrl_gym_torch.envs.wordle.vector import N_TRIES, WordleVectorEnv, WordleVocab
from lmrl_gym_torch.loops import actor
from lmrl_gym_torch.models.config import TransformerConfig, gpt2_small
from lmrl_gym_torch.models.heads import MLPHead, MLPHeadConfig
from lmrl_gym_torch.models.interface import LMCore
from lmrl_gym_torch.models.transformer import init_params

# H100 SXM published dense peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
CPU_NOMINAL_FLOPS = 100e12  # bench.py:57's nominal value for CPU test runs
NEXT_T = 16  # the ILQL batches' next window
MARKOV_TURNS = 8


def _peak_flops_per_chip(device: DeviceLike = "cuda") -> float:
    """bf16 dense peak of the card `device` names, for the MFU estimate: an
    H100's 989 TF/s. Any other CUDA card raises (its peak is not in the
    table); a CPU device gets bench.py's nominal value."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return CPU_NOMINAL_FLOPS
    name = torch.cuda.get_device_name(dev)
    if "H100" in name:
        return PEAK_FLOPS[torch.bfloat16]
    raise ValueError(f"no bf16 peak known for {name!r}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------- ILQL ----------------

def ilql_config(vocab_size: int, pad_multiple: int) -> TransformerConfig:
    """bench.py's ILQL trunk: d768 L12 H12, 1,024 positions, no dropout."""
    return TransformerConfig(vocab_size=vocab_size, hidden_size=768, num_layers=12, num_heads=12,
                             max_position_embeddings=1024, pad_vocab_to_multiple=pad_multiple, embd_pdrop=0.0,
                             resid_pdrop=0.0, attn_pdrop=0.0)


def ilql_batch(B: int, T: int, device: DeviceLike) -> ilql.ILQLBatch:
    """bench.py:123-133's batch, drawn as it draws it from
    `np.random.default_rng(0)`: byte tokens, an action on every other
    token with reward −1 each, no episode done, a next window whose
    episode is done."""
    rng = np.random.default_rng(0)
    sta = np.zeros((B, T - 1), bool)
    sta[:, 1::2] = True
    arrays = (rng.integers(1, 256, (B, T)), sta, -1.0 * sta.astype(np.float32), np.zeros((B,), bool),
              rng.integers(1, 256, (B, NEXT_T)), np.ones((B,), bool))
    return ilql.ILQLBatch(*(torch.from_numpy(np.asarray(a)).to(device) for a in arrays))


def ilql_state(config: TransformerConfig, pad_id: int, device: DeviceLike = "cuda", mesh=None):
    """(state, step) of bench.py's ILQL step: the trunk (f32 parameters,
    the config's activations), twin MLP Q heads and a V head at hidden 2·D
    with a zero second layer, `init_ilql_state` with a separate target
    base, AdamW at 1e-4 (trunk) and 1e-3 (heads). Weights from seeds 0
    (trunk) and 1, 2, 3 (q1, q2, v). Under a distributed `mesh` every
    module is sharded by its rule table."""
    from lmrl_gym_torch.parallel.mesh import shard_train_state

    device = resolve_device(device)
    D = config.hidden_size
    q_cfg = MLPHeadConfig(D, 2 * D, config.padded_vocab_size, layer2_initializer_range=0.0)
    v_cfg = MLPHeadConfig(D, 2 * D, 1, layer2_initializer_range=0.0)
    ilql_config = ilql.ILQLConfig()
    state = ilql.init_ilql_state(
        init_params(config, seed=0, device=device), MLPHead(q_cfg, device=device, seed=1),
        MLPHead(q_cfg, device=device, seed=2), MLPHead(v_cfg, device=device, seed=3), adamw(1e-4), adamw(1e-3),
        ilql_config,
    )
    if mesh is not None:
        shard_train_state(state, mesh)
    return state, ilql.make_ilql_train_step(LMCore(config, device, mesh), ilql_config, pad_id, mesh)


def ilql_setup(config: TransformerConfig, B: int, T: int, pad_id: int, device: DeviceLike = "cuda"):
    """(state, step, batch): `ilql_state` and `ilql_batch`."""
    return (*ilql_state(config, pad_id, device), ilql_batch(B, T, device))


def time_ilql(state, step, batch, reps: int) -> Tuple[float, float]:
    """One warm-up step, then `reps` timed: (seconds per step, the last
    loss). The window ends at a value fetch, as bench.py's `float(loss)`."""
    device = batch.input_ids.device
    state, loss, _ = step(state, batch)
    _sync(device)
    float(loss)
    t0 = time.perf_counter()
    for _ in range(reps):
        state, loss, _ = step(state, batch)
    _sync(device)
    last = float(loss)
    return (time.perf_counter() - t0) / reps, last


def n_params(module) -> int:
    return sum(p.numel() for p in module.parameters())


def ilql_update_flops(config: TransformerConfig, B: int, T: int, next_T: int, n_base: int, n_head: int,
                      n_v: int) -> int:
    """One ILQL update's matmul FLOPs as bench.py counts them (:147-164,
    :319-337): the trained trunk forward + backward (6 N per token), the
    target trunk and next-window forwards (2 N), q1 / q2 / v forward +
    backward, the target Q heads' forwards and the attention products
    (3 × 2·(QKᵀ + PV) over the full T×T square)."""
    L, H, Dh = config.num_layers, config.num_heads, config.head_dim
    tok_main, tok_next = B * T, B * next_T
    attn_fwd = 4 * L * H * Dh * T * tok_main
    return (tok_main * 6 * n_base + tok_main * 2 * n_base + tok_next * 2 * n_base
            + tok_main * (2 * 6 * n_head + 6 * n_v) + tok_main * 2 * 2 * n_head + 3 * attn_fwd)


def _ilql_section(config: TransformerConfig, pad_id: int, B: int, T: int, reps: int, device) -> Tuple[float, float]:
    """(updates/s, MFU) of bench.py's ILQL step at this point."""
    state, step, batch = ilql_setup(config, B, T, pad_id, device)
    dt, _ = time_ilql(state, step, batch, reps)
    flops = ilql_update_flops(config, B, T, NEXT_T, n_params(state.base.params), n_params(state.q1_head.params),
                              n_params(state.v_head.params))
    return 1.0 / dt, flops / dt / _peak_flops_per_chip(batch.input_ids.device)


def bench_ilql(B: int = 32, T: int = 160, reps: int = 20, device: DeviceLike = "cuda",
               config: Optional[TransformerConfig] = None) -> dict:
    """bench.py:60: the ILQL step over the byte vocab (259 ids padded to
    320, pad id 256)."""
    config = config or ilql_config(259, 64)
    ups, mfu = _ilql_section(config, 256, B, T, reps, device)
    return {
        "ilql_updates_per_s_gpt2small": round(ups, 3),
        "ilql_tokens_per_s": round(ups * B * T, 1),
        "ilql_mfu_pct": round(100 * mfu, 2),
        "ilql_model": f"d{config.hidden_size} L{config.num_layers} H{config.num_heads} vocab{config.vocab_size} "
                      f"B{B} T{T}",
    }


def bench_ilql_real_vocab(B: int = 32, T: int = 160, reps: int = 10, device: DeviceLike = "cuda",
                          config: Optional[TransformerConfig] = None) -> dict:
    """bench.py:232: the ILQL step at GPT-2's 50,257 ids (padded to 50,304,
    pad id 50,256), the reference's operating point."""
    config = config or ilql_config(50257, 128)
    ups, mfu = _ilql_section(config, 50256, B, T, reps, device)
    return {
        "ilql_updates_per_s_vocab50257": round(ups, 3),
        "ilql_tokens_per_s_vocab50257": round(ups * B * T, 1),
        "ilql_mfu_pct_vocab50257": round(100 * mfu, 2),
        "ilql_model_vocab50257": f"d{config.hidden_size} L{config.num_layers} H{config.num_heads} vocab50257 "
                                 f"B{B} T{T}",
    }


# ---------------- actors ----------------

def actor_config(vocab_size: int) -> TransformerConfig:
    """GPT-2-small over `vocab_size` ids padded to a multiple of 128, no
    dropout: bench.py's serving configs."""
    return gpt2_small().replace(vocab_size=vocab_size, pad_vocab_to_multiple=128, embd_pdrop=0.0, resid_pdrop=0.0,
                                attn_pdrop=0.0)


def _serving_params(config: TransformerConfig, device, serve_f32: bool):
    """The policy's weights from seed 0: bf16 (decode reads every weight
    per token) unless `serve_f32`."""
    return init_params(config, seed=0, device=device, dtype=torch.float32 if serve_f32 else torch.bfloat16)


def _wordle_actor(config: TransformerConfig, B: int, reps: int, device, serve_f32: bool) -> Tuple[float, float]:
    """(env-steps/s, tokens/s) of `rollout_wordle` with a plain-LM policy:
    one warm-up rollout, then `reps` timed, each ending at a value fetch."""
    device = resolve_device(device)
    env = WordleVectorEnv(WordleVocab.from_file(), device=device)
    params = _serving_params(config, device, serve_f32)
    step_fn, carry0 = actor.make_lm_step_fn(LMCore(config, device), B)
    gen = torch.Generator(device=device).manual_seed(0)
    out = actor.rollout_wordle(env, step_fn, params, carry0, B, generator=gen)
    _sync(device)
    float(out.turn_reward.sum())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = actor.rollout_wordle(env, step_fn, params, carry0, B, generator=gen)
        _sync(device)
        float(out.turn_reward.sum())
    dt = time.perf_counter() - t0
    return B * N_TRIES * reps / dt, B * actor.EPISODE_LEN * reps / dt


def bench_actor(B: int = 512, reps: int = 5, device: DeviceLike = "cuda", serve_f32: bool = False,
                config: Optional[TransformerConfig] = None) -> dict:
    """bench.py:177: the fused Wordle actor, GPT-2-small over 512 ids."""
    config = config or actor_config(512)
    env_steps, tok_s = _wordle_actor(config, B, reps, device, serve_f32)
    return {
        "fused_actor_env_steps_per_s_per_chip": round(env_steps, 1),
        "fused_actor_tokens_per_s_per_chip": round(tok_s, 1),
        "fused_actor_model": f"d{config.hidden_size} L{config.num_layers} H{config.num_heads} "
                             f"vocab{config.vocab_size} B{B}",
    }


def bench_actor_real_vocab(B: int = 512, reps: int = 3, device: DeviceLike = "cuda", serve_f32: bool = False,
                           config: Optional[TransformerConfig] = None) -> dict:
    """bench.py:346: the fused Wordle actor at GPT-2's 50,257 ids."""
    config = config or actor_config(50257)
    env_steps, tok_s = _wordle_actor(config, B, reps, device, serve_f32)
    return {
        "fused_actor_env_steps_per_s_per_chip_vocab50257": round(env_steps, 1),
        "fused_actor_tokens_per_s_per_chip_vocab50257": round(tok_s, 1),
        "fused_actor_model_vocab50257": f"d{config.hidden_size} L{config.num_layers} H{config.num_heads} "
                                        f"vocab50257 B{B}",
    }


def markov_envs(device: DeviceLike = "cuda") -> dict:
    """bench.py:414-424's envs: the maze (double_t_maze, its goal) and KQ-K
    chess (FEN observations), each cut to MARKOV_TURNS moves."""
    maze = MazeTokenVecEnv(MazeVectorEnv(double_t_maze(), valid_goals=np.asarray([DOUBLE_T_GOAL], np.int32),
                                         max_steps=MARKOV_TURNS, device=device))
    return {"maze": maze, "chess": ChessEndgameVectorEnv(max_steps=MARKOV_TURNS, device=device)}


def bench_actor_markov(B: int = 512, reps: int = 3, device: DeviceLike = "cuda",
                       config: Optional[TransformerConfig] = None) -> dict:
    """bench.py:398: `rollout_markov` of a GPT-2-small-class policy (512
    ids, bf16 weights, positions at least the turn's window) on each env,
    the caches restarting every turn: one warm-up and `reps` timed
    rollouts from one reset state."""
    device = resolve_device(device)
    out = {}
    for name, env in markov_envs(device).items():
        total_len = env.OBS_LEN + env.ACT_LEN
        cfg = (config or actor_config(512)).replace(max_position_embeddings=max(128, total_len))
        params = _serving_params(cfg, device, serve_f32=False)
        step_fn, carry0 = actor.make_lm_step_fn(LMCore(cfg, device), B, total_len=total_len)
        gen = torch.Generator(device=device).manual_seed(1)
        state0 = env.reset(B, gen)
        roll, _ = actor.rollout_markov(env, MARKOV_TURNS, step_fn, params, carry0, state0, generator=gen)
        _sync(device)
        float(roll.turn_reward.sum())
        t0 = time.perf_counter()
        for _ in range(reps):
            roll, _ = actor.rollout_markov(env, MARKOV_TURNS, step_fn, params, carry0, state0, generator=gen)
            _sync(device)
            float(roll.turn_reward.sum())
        dt = time.perf_counter() - t0
        out[f"fused_{name}_actor_env_steps_per_s_per_chip"] = round(B * MARKOV_TURNS * reps / dt, 1)
    return out


def bench_env(B: int = 8192, reps: int = 20, device: DeviceLike = "cuda") -> dict:
    """bench.py:462: full 6-turn episodes of the vector Wordle env under
    the random-consistent-guess policy, B games per rollout."""
    device = resolve_device(device)
    env = WordleVectorEnv(WordleVocab.from_file(), device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    _, total, _ = env.rollout_episodes(B, gen)
    _sync(device)
    float(total.sum())
    t0 = time.perf_counter()
    for _ in range(reps):
        _, total, _ = env.rollout_episodes(B, gen)
        _sync(device)
        float(total.sum())
    per_card = B * N_TRIES * reps / (time.perf_counter() - t0)
    return {
        "metric": "wordle_batched_env_steps_per_s_per_chip",
        "value": round(per_card, 1),
        "unit": "env-steps/s/chip",
        "vs_baseline": round(per_card / 10_000.0, 3),
    }


# bench.py:529-549: one section per mode; "all" runs the real-vocab
# sections first, then the rest, and bench_env last
MODES = {
    "ilql": ("bench_ilql",),
    "actor": ("bench_actor",),
    "markov": ("bench_actor_markov",),
    "env": ("bench_env",),
    "all": ("bench_ilql_real_vocab", "bench_actor_real_vocab", "bench_actor", "bench_ilql", "bench_actor_markov",
            "bench_env"),
}


def section_kwargs(name: str) -> dict:
    """A section's sizes from the JAX bench's environment variables
    (`BENCH_BATCH`, `BENCH_SEQ`, `BENCH_REPS`, `BENCH_SERVE_F32`); unset
    ones keep the section's defaults."""
    environ, kw = os.environ, {}
    if "BENCH_BATCH" in environ:
        kw["B"] = int(environ["BENCH_BATCH"])
    if "BENCH_SEQ" in environ and name.startswith("bench_ilql"):
        kw["T"] = int(environ["BENCH_SEQ"])
    if "BENCH_REPS" in environ:
        kw["reps"] = int(environ["BENCH_REPS"])
    if name in ("bench_actor", "bench_actor_real_vocab"):
        kw["serve_f32"] = environ.get("BENCH_SERVE_F32") == "1"
    return kw


def main(argv=None) -> dict:
    """Runs the sections `BENCH_MODE` names (default all) on `--device`
    and prints one JSON line of their keys; returns the same dict. A
    section that fails raises."""
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    mode = os.environ.get("BENCH_MODE", "all")
    if mode not in MODES:
        raise ValueError(f"BENCH_MODE={mode!r}: one of {sorted(MODES)}")
    result = {}
    for name in MODES[mode]:
        result.update(globals()[name](device=device, **section_kwargs(name)))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
