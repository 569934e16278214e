"""Chess mate-in-1 ILQL gate on the port: the port of
`scripts/chess_ilql_gate.py`, with the same flags, defaults, stages and
JSON keys, plus `--device`.

    python -m lmrl_gym_torch.scripts.chess_ilql_gate --obs grid   # on the card
    python -m lmrl_gym_torch.scripts.chess_ilql_gate --device cpu # plain path

BASELINE config #4, chess endgames (KQ-K) with ILQL, on the vectorized
chess env (`envs/chess/vector.py`):

  1. BC on random-legal frames over random endgame positions, so the trunk
     speaks the FEN/SAN protocol;
  2. offline ILQL on random-legal behavior over a TRAIN pool of mate-in-1
     positions (sampled by the env, classified by the native engine), with
     --curriculum of the behavior actions playing the mating move;
  3. eval on a HELD-OUT pool: the reranker (enumerate the env's legal
     moves, score each by Σ_action(min(Q1,Q2) − V), take the argmax; the
     reference's ReRankerPolicy), the β-guided greedy decode through
     `rollout_markov` (two trunks: the BC trunk as π_β), and the guided
     greedy decode masked to the legal SAN set (`generate_constrained`),
     beside the random-legal baseline.

Draws come from `torch.Generator`s seeded from --seed; a `Replay` hands the
gate another run's draws and initial weights, so a test can hold it to the
JAX gate on the JAX gate's own draws. The black reply of an eval or
behavior step never changes its reward (mate and legality are decided
before the reply), so replies always come from the gate's generator.
"""
from __future__ import annotations

import argparse
import copy
import json
import time
from typing import Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

PROBE = 512  # positions per pool probe
SCORE_CHUNK = 4096  # reranker candidates per score call
PAD_ID = 256


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--train-pool", type=int, default=1024)
    p.add_argument("--eval-pool", type=int, default=256)
    p.add_argument("--bc-batches", type=int, default=1500)
    p.add_argument("--bc-bsize", type=int, default=64)
    p.add_argument("--ilql-batches", type=int, default=8000)
    p.add_argument("--ilql-bsize", type=int, default=512)
    p.add_argument("--eval-every", type=int, default=2000)
    p.add_argument("--curriculum", type=float, default=0.3,
                   help="fraction of behavior actions that play the engine-classified mating move "
                   "(0 = pure uniform-legal)")
    p.add_argument("--obs", choices=["fen", "grid"], default="fen",
                   help="observation rendering: 'fen' = the reference protocol (spelled FEN); 'grid' = 8x8 board "
                   "tokens, which a small trunk trained from scratch reads more easily")
    p.add_argument("--freeze-base", action="store_true", help="heads-only ILQL on the frozen BC trunk")
    p.add_argument("--beta", type=float, default=4.0)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda", help="cuda (the card) or cpu (the plain path)")
    return p.parse_args(argv)


def first_mate_move(fen: str) -> Optional[str]:
    """The first mating SAN of a mate-in-1 position, else None."""
    from lmrl_gym_torch.envs.chess.engine import CHECKMATE, Board

    for m in Board(fen).legal_moves_san():
        c = Board(fen)
        c.push_san(m)
        if c.game_state() == CHECKMATE:
            return m
    return None


def san_to_kernel_action(san: str) -> Tuple[bool, int]:
    """'Qd5#' → (is_king, dst) in the env's action encoding (KQ-K has no
    captures or disambiguation: SAN is the piece letter and the square)."""
    s = san.rstrip("#+")
    return s[0] == "K", (ord(s[-1]) - ord("1")) * 8 + (ord(s[-2]) - ord("a"))


def sample_mate_in_1_states(env, batch: int, generator: Optional[torch.Generator] = None,
                            probes: Optional[Iterator] = None):
    """Positions sampled by the env in probes of PROBE, kept when the native
    engine finds a mate in one, until `batch` are kept; with each position's
    first mating move in the env's encoding. `probes` replays each probe's
    reset squares. Returns (pool, (mate_is_king, mate_dst))."""
    from lmrl_gym_torch.envs.chess.vector import ChessVecState

    cols = {k: [] for k in ("wk", "pc", "bk", "mk", "md")}
    while len(cols["wk"]) < batch:
        state = env.reset(PROBE, generator, None if probes is None else next(probes))
        fens = env.fen_strings(state)
        wk, pc, bk = (x.cpu().numpy() for x in (state.wk, state.pc, state.bk))
        for i, f in enumerate(fens):
            if len(cols["wk"]) >= batch:
                break
            san = first_mate_move(f)
            if san is not None:
                mk, md = san_to_kernel_action(san)
                for k, v in zip(("wk", "pc", "bk", "mk", "md"), (wk[i], pc[i], bk[i], mk, md)):
                    cols[k].append(int(v))
    dev = env.device

    def z(dtype=torch.int32):
        return torch.zeros((batch,), dtype=dtype, device=dev)

    def col(k):
        return torch.tensor(cols[k], dtype=torch.int64, device=dev)

    pool = ChessVecState(wk=col("wk"), pc=col("pc"), bk=col("bk"), halfmove=z(), fullmove=z() + 1, n_steps=z(),
                         done=z(torch.bool), reward=z(torch.float32), illegal=z(torch.bool))
    return pool, (col("mk").bool(), col("md"))


class Replay(NamedTuple):
    """Another run's draws and initial weights: each pool probe's reset
    squares [3, 8, PROBE]; per BC batch (reset squares [3, 8, B], the
    random-legal action's Gumbels [B, 128]); per ILQL batch (pool indices
    [B], the action's Gumbels [B, 128], the curriculum's uniforms [B]); the
    random baseline's action Gumbels [P, 128]; the initial trunk and
    (q1, q2, v) heads."""

    probes: Iterator
    bc: Iterator
    behavior: Iterator
    baseline: torch.Tensor
    trunk: torch.nn.Module
    heads: Tuple[torch.nn.Module, torch.nn.Module, torch.nn.Module]


class Gate:
    """The gate's env, model and eval harness, built from its flags; one
    method per stage. `dtype` is the trunk's activation dtype (bf16, as
    the JAX gate runs)."""

    def __init__(self, args: argparse.Namespace, dtype: str = "bfloat16", replay: Optional[Replay] = None):
        from lmrl_gym_torch.core.device import resolve_device
        from lmrl_gym_torch.envs.chess.vector import ChessEndgameVectorEnv
        from lmrl_gym_torch.models.config import TransformerConfig
        from lmrl_gym_torch.models.interface import LMCore

        self.args = args
        self.replay = replay
        self.device = resolve_device(args.device)
        self.t_start = time.time()
        self.env = ChessEndgameVectorEnv(max_steps=1, obs_mode=args.obs, device=self.device)
        self.W = self.env.OBS_LEN + self.env.ACT_LEN
        self.config = TransformerConfig(
            vocab_size=259, hidden_size=args.hidden, num_layers=args.layers, num_heads=args.heads,
            max_position_embeddings=self.W, pad_vocab_to_multiple=64,
            embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype=dtype,
        )
        self.core = LMCore(self.config, device=self.device)
        # one stream for the pools, BC and ILQL draws, as the JAX gate splits one key
        self.gen = torch.Generator(device=self.device).manual_seed(args.seed)

    def log(self, msg: str) -> None:
        print(f"{msg} ({time.time() - self.t_start:.0f}s)", flush=True)

    def fixed_gen(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def initial_weights(self):
        """(trunk, (q1, q2, v)): the replayed ones, else the trunk from seed 0
        and MLP heads (hidden 2·D, second layer zero) from seeds 2, 3, 4."""
        if self.replay is not None:
            return self.replay.trunk, self.replay.heads
        from lmrl_gym_torch.models.heads import MLPHead, MLPHeadConfig
        from lmrl_gym_torch.models.transformer import init_params

        D = self.config.hidden_size
        kw = dict(input_dim=D, hidden_dim=2 * D, layer2_initializer_range=0.0)
        q_cfg = MLPHeadConfig(output_dim=self.config.padded_vocab_size, **kw)
        heads = (MLPHead(q_cfg, device=self.device, seed=2), MLPHead(q_cfg, device=self.device, seed=3),
                 MLPHead(MLPHeadConfig(output_dim=1, **kw), device=self.device, seed=4))
        return init_params(self.config, seed=0, device=self.device), heads

    # ---- the mate-in-1 pools
    def pools(self):
        """(train pool, its mating moves, held-out pool)."""
        from lmrl_gym_torch.envs.chess.vector import state_slice

        args = self.args
        n_train = args.train_pool
        probes = None if self.replay is None else self.replay.probes
        full, (mate_k, mate_d) = sample_mate_in_1_states(self.env, n_train + args.eval_pool, self.gen, probes)
        return (state_slice(full, slice(0, n_train)), (mate_k[:n_train], mate_d[:n_train]),
                state_slice(full, slice(n_train, n_train + args.eval_pool)))

    # ---- stage 1: BC on random-legal frames over random endgames
    def train_bc(self):
        """--bc-batches steps from a copy of the initial trunk; returns
        (params, last loss)."""
        from lmrl_gym_torch.algos.bc import BCBatch, BCConfig, BCTrainState, make_bc_train_step
        from lmrl_gym_torch.core.optimizer import OptimizerConfig, TrainState, make_optimizer

        args, env = self.args, self.env
        params = copy.deepcopy(self.initial_weights()[0])
        state = BCTrainState(TrainState(params, make_optimizer(OptimizerConfig(lr=args.lr), params)))
        step = make_bc_train_step(self.core, BCConfig(), PAD_ID)
        mask = torch.zeros((args.bc_bsize, self.W), dtype=torch.float32, device=self.device)
        mask[:, env.OBS_LEN:] = 1.0
        loss = torch.zeros(())
        for _ in range(args.bc_batches):
            squares, gumbel = (None, None) if self.replay is None else next(self.replay.bc)
            st = env.reset(args.bc_bsize, self.gen, squares)
            windows = torch.cat([env.obs_tokens(st), env.random_legal_action(st, self.gen, gumbel)], dim=1)
            state, loss, _ = step(state, BCBatch(windows, mask))
        return state.model.params, float(loss)

    # ---- stage 2: offline ILQL on random-legal behavior over the train pool
    def init_ilql(self, bc_params):
        """The ILQL state on a copy of the BC trunk and copies of the initial
        heads (no separate target base). Returns (state, ilql_config)."""
        from lmrl_gym_torch.algos.ilql import ILQLConfig, init_ilql_state
        from lmrl_gym_torch.core import optimizer as opt

        args = self.args
        config = ILQLConfig(use_separate_target_base=False, beta=args.beta, freeze_base=args.freeze_base)
        base_tx = opt.set_to_zero() if args.freeze_base else opt.adamw(args.lr * 0.3)
        q1, q2, v = (copy.deepcopy(h) for h in self.initial_weights()[1])
        return init_ilql_state(copy.deepcopy(bc_params), q1, q2, v, base_tx, opt.adamw(args.lr), config), config

    def behavior_batch(self, train_pool, mate):
        """One batch: train-pool positions, a uniform-legal move — or, with
        probability --curriculum, the mating move — and the env's reward on
        the action's last token. Returns (windows, rewards)."""
        from lmrl_gym_torch.envs.chess.vector import state_slice

        args, env, Bi = self.args, self.env, self.args.ilql_bsize
        idx, gumbel, uniform = (None, None, None) if self.replay is None else next(self.replay.behavior)
        if idx is None:
            idx = torch.randint(0, args.train_pool, (Bi,), generator=self.gen, device=self.device)
        idx = idx.to(self.device).long()
        st = state_slice(train_pool, idx)
        obs = env.obs_tokens(st)
        act = env.random_legal_action(st, self.gen, gumbel)
        if args.curriculum > 0:
            mate_act = env.render_san(mate[0][idx], mate[1][idx])
            if uniform is None:
                uniform = torch.rand((Bi,), generator=self.gen, device=self.device)
            act = torch.where((uniform.to(self.device) < args.curriculum)[:, None], mate_act, act)
        stepped = env.step(st, act, self.gen)
        rewards = torch.zeros((Bi, self.W - 1), dtype=torch.float32, device=self.device)
        rewards[:, self.W - 2] = stepped.reward
        return torch.cat([obs, act], dim=1), rewards

    def train_ilql(self, state, ilql_config, train_pool, mate, eval_pool):
        """--ilql-batches steps, a held-out reranker eval every --eval-every.
        Returns (state, last loss, curve)."""
        from lmrl_gym_torch.algos.ilql import ILQLBatch, make_ilql_train_step

        args, Bi = self.args, self.args.ilql_bsize
        step = make_ilql_train_step(self.core, ilql_config, PAD_ID)
        sta = torch.zeros((Bi, self.W - 1), dtype=torch.bool, device=self.device)
        sta[:, self.env.OBS_LEN - 1:] = True
        dones = torch.ones((Bi,), dtype=torch.bool, device=self.device)
        curve, loss = [], torch.zeros(())
        for i in range(args.ilql_batches):
            windows, rewards = self.behavior_batch(train_pool, mate)
            state, loss, _ = step(state, ILQLBatch(windows, sta, rewards, dones, None, None))
            if (i + 1) % args.eval_every == 0:
                r = self.rerank_mate_rate(state, eval_pool, f"[batch {i + 1}] held-out")
                curve.append(dict(batch=i + 1, rerank=r, loss=float(loss)))
        return state, float(loss), curve

    # ---- stage 3: evals
    def mate_rates(self, pool, act) -> Tuple[float, float]:
        """(mate rate, illegal rate) of one move per position."""
        reward = self.env.step(pool, act, self.fixed_gen(0)).reward.cpu().numpy()
        return float((reward == 1.0).mean()), float((reward == -1.0).mean())

    def random_baseline(self, pool) -> float:
        gumbel = None if self.replay is None else self.replay.baseline
        return self.mate_rates(pool, self.env.random_legal_action(pool, self.fixed_gen(99), gumbel))[0]

    def legal_moves(self, pool) -> List[Tuple[int, bool, int]]:
        """(position, is_king, dst) of every legal move, king moves first."""
        k_legal, p_legal = (x.cpu().numpy() for x in self.env.agent_legal_moves(pool))
        rows = []
        for i in range(k_legal.shape[0]):
            rows += [(i, True, int(d)) for d in np.flatnonzero(k_legal[i])]
            rows += [(i, False, int(d)) for d in np.flatnonzero(p_legal[i])]
        return rows

    def _render(self, moves) -> torch.Tensor:
        return self.env.render_san(torch.tensor([m[1] for m in moves], device=self.device),
                                   torch.tensor([m[2] for m in moves], device=self.device))

    def rerank_mate_rate(self, state, pool, tag: str) -> float:
        """Every legal move scored by Σ_action(min(Q1,Q2) − V); the argmax
        per position is played."""
        from lmrl_gym_torch.algos.value_policy import ValueRLParams, make_ilql_score_fn

        rows = self.legal_moves(pool)
        pos_idx = np.asarray([r[0] for r in rows])
        obs = self.env.obs_tokens(pool)[torch.as_tensor(pos_idx, device=self.device)]
        ids = torch.cat([obs, self._render(rows)], dim=1)
        amask = torch.zeros(ids.shape, dtype=torch.bool, device=self.device)
        amask[:, self.env.OBS_LEN:] = True
        bundle = ValueRLParams(pi_beta=None, base=state.base.params, q1_head=state.q1_head.params,
                               q2_head=state.q2_head.params, v_head=state.v_head.params)
        score_fn = make_ilql_score_fn(self.core, bundle, PAD_ID)
        scores = np.concatenate([score_fn(ids[lo:lo + SCORE_CHUNK], amask[lo:lo + SCORE_CHUNK]).float().cpu().numpy()
                                 for lo in range(0, ids.shape[0], SCORE_CHUNK)])
        n = int(pool.wk.shape[0])
        picks = []
        for i in range(n):
            rows_i = np.flatnonzero(pos_idx == i)
            picks.append(rows[rows_i[np.argmax(scores[rows_i])]])
        rate = self.mate_rates(pool, self._render(picks))[0]
        self.log(f"{tag}: reranker mate rate {rate:.3f} over {n} positions ({len(rows)} candidate moves)")
        return rate

    def guided_params(self, state, bc_params) -> dict:
        return {"pi_beta": bc_params, "base": state.base.params, "q1": state.q1_head.params,
                "q2": state.q2_head.params}

    def guided_greedy(self, state, bc_params, pool) -> Tuple[float, float]:
        """One greedy turn of π_β + β·min(Q1,Q2) through `rollout_markov`."""
        from lmrl_gym_torch.loops import actor

        B = int(pool.wk.shape[0])
        step_fn, carry = actor.make_value_guided_step_fn(self.core, B, two_trunks=True, twin_q=True,
                                                         beta=self.args.beta, total_len=self.W)
        out, _ = actor.rollout_markov(self.env, 1, step_fn, self.guided_params(state, bc_params), carry, pool,
                                      1.0, True, generator=self.fixed_gen(0))
        r = out.turn_reward[:, 0]
        rate, ill = float((r == 1.0).float().mean()), float((r == -1.0).float().mean())
        self.log(f"ILQL guided greedy (held-out): mate {rate:.3f} illegal {ill:.3f}")
        return rate, ill

    def guided_legal(self, state, bc_params, pool) -> Tuple[float, float]:
        """The guided greedy decode masked to each position's legal SAN
        frames (`generate_constrained`): the policy still chooses, but only
        among legal continuations."""
        from lmrl_gym_torch.loops import actor
        from lmrl_gym_torch.models.generation import SamplingConfig, generate_constrained

        env, B = self.env, int(pool.wk.shape[0])
        rows = self.legal_moves(pool)
        frames = self._render(rows).cpu().numpy()
        counts = np.bincount([r[0] for r in rows], minlength=B)
        P = int(counts.max())
        cands = np.full((B, P, env.ACT_LEN), PAD_ID, np.int64)
        cmask = np.zeros((B, P), bool)
        slot = np.zeros(B, np.int64)
        for r, (i, _, _) in enumerate(rows):
            cands[i, slot[i]] = frames[r]
            cmask[i, slot[i]] = True
            slot[i] += 1
        params = self.guided_params(state, bc_params)
        step_fn, carry0 = actor.make_value_guided_step_fn(self.core, B, two_trunks=True, twin_q=True,
                                                          beta=self.args.beta, total_len=self.W)

        def logits_fn(toks, attn_mask, carry):
            return step_fn(params, toks, carry)

        obs = env.obs_tokens(pool)
        sampling = SamplingConfig(max_new_tokens=env.ACT_LEN, greedy=True, eos_token_id=10, pad_token_id=PAD_ID)
        toks, _ = generate_constrained(logits_fn, carry0, obs, torch.ones_like(obs, dtype=torch.int32), sampling,
                                       torch.as_tensor(cands, device=self.device),
                                       torch.as_tensor(cmask, device=self.device))
        # the emitted frame (piece at 0, file at 2, rank at 4) in the env's encoding
        is_king = toks[:, 0] == ord("K")
        dst = ((toks[:, 4] - ord("1")) * 8 + (toks[:, 2] - ord("a"))).clamp(0, 63)
        rate, ill = self.mate_rates(pool, env.render_san(is_king, dst))
        self.log(f"ILQL guided+legal (held-out): legality-masked guided greedy mate {rate:.3f} "
                 f"illegal {ill:.3f} (P_max={P})")
        return rate, ill


def run(g: Gate) -> dict:
    """Every stage in the JAX gate's order; returns its JSON result."""
    from lmrl_gym_torch.envs.chess.vector import state_slice

    args = g.args
    train_pool, mate, eval_pool = g.pools()
    g.log(f"pools: {args.train_pool} train / {args.eval_pool} HELD-OUT mate-in-1 positions")

    bc_params, bc_loss = g.train_bc()
    g.log(f"BC: {args.bc_batches} batches, loss {bc_loss:.3f}")

    state, ilql_config = g.init_ilql(bc_params)
    base_rate = g.random_baseline(eval_pool)
    g.log(f"random-legal baseline mate rate (held-out): {base_rate:.3f}")
    state, loss, curve = g.train_ilql(state, ilql_config, train_pool, mate, eval_pool)
    g.log(f"ILQL: {args.ilql_batches} offline batches, loss {loss:.3f}")

    rerank_rate = g.rerank_mate_rate(state, eval_pool, "ILQL values (held-out)")
    rerank_rate_train = g.rerank_mate_rate(state, state_slice(train_pool, slice(0, args.eval_pool)),
                                           "ILQL values (train)")
    guided_rate, guided_ill = g.guided_greedy(state, bc_params, eval_pool)
    guided_legal_rate, guided_legal_ill = g.guided_legal(state, bc_params, eval_pool)
    return dict(
        random_rate=base_rate,
        rerank_rate=rerank_rate,
        rerank_rate_train=rerank_rate_train,
        guided_rate=guided_rate,
        guided_illegal=guided_ill,
        guided_legal_rate=guided_legal_rate,
        guided_legal_illegal=guided_legal_ill,
        curve=curve,
    )


def main(argv=None):
    args = parse_args(argv)
    g = Gate(args)
    result = run(g)
    print(f"gate wall time: {time.time() - g.t_start:.1f} s on {g.device.type}", flush=True)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(args=vars(args), **result), f, indent=1)
    return result


if __name__ == "__main__":
    main()
