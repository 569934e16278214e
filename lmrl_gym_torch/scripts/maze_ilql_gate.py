"""Maze value-learning gate on the port: the port of
`scripts/maze_ilql_gate.py`, with the same flags, defaults, stages and JSON
keys, plus `--device`.

    python -m lmrl_gym_torch.scripts.maze_ilql_gate --algo cql   # on the card
    python -m lmrl_gym_torch.scripts.maze_ilql_gate --device cpu # plain path

  1. behavior data with an adversarial mode: --p-optimal of the mass on
     the BFS-optimal action, the rest on a fixed wrong action, so BC's
     greedy imitation is systematically wrong and only value learning can
     recover the optimal moves;
  2. BC pretraining, then its greedy per-cell accuracy (`LMServer`);
  3. offline ILQL, MC or CQL from the BC trunk; every --eval-every epochs
     the per-cell accuracy of the β-guided decode (π_β + β·min(q1,q2),
     optionally masked to the four legal moves), and of the reranker over
     the four move proposals with the online and with the target heads.

The JAX gate's draws are its weights' initialisation (the data and batch
order come from the same numpy RNG calls in both packages, and every
decode is greedy), so a `Replay` of the JAX gate's initial trunk and
heads holds this gate to the JAX gate.
"""
from __future__ import annotations

import argparse
import copy
import json
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

MAX_LEN, GOAL = 160, (8, 6)
ACTION_PROPOSALS = ["move up\n", "move down\n", "move left\n", "move right\n"]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--algo", choices=["ilql", "mc", "cql"], default="ilql",
                   help="mc: single-Q reward-to-go regression + mean-Q reranker; cql: twin-Q SARSA + CQL "
                   "regularizer (ILQL without the V head)")
    p.add_argument("--lr-warmdown", action="store_true",
                   help="cosine-decay the head lr to 0 over the training run")
    p.add_argument("--guided-legal", action="store_true",
                   help="constrain the guided decode to the 4 legal maze actions (`generate_constrained`)")
    p.add_argument("--eval-heads", choices=["online", "target"], default="online",
                   help="run the guided eval through the online heads or the polyak target heads")
    p.add_argument("--n-chains", type=int, default=400)
    p.add_argument("--p-optimal", type=float, default=0.35)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--bc-epochs", type=int, default=4)
    p.add_argument("--ilql-epochs", type=int, default=12)
    p.add_argument("--eval-every", type=int, default=2)
    p.add_argument("--bsize", type=int, default=32)
    p.add_argument("--grad-accum", type=int, default=1,
                   help="MultiSteps on the optimizers: effective batch bsize*accum; polyak is accum-gated")
    p.add_argument("--beta", type=float, default=8.0)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--polyak", type=float, default=0.005)
    p.add_argument("--value-bias-init", type=float, default=0.0, help="last-layer bias init of the Q/V heads")
    p.add_argument("--freeze-base", action="store_true",
                   help="heads-only value learning on stop-gradient trunk features")
    p.add_argument("--lr", type=float, default=None,
                   help="default 1e-3 (3e-4 under --gpt2-small); explicit values are never overridden")
    p.add_argument("--seed", type=int, default=5)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--gpt2-small", action="store_true",
                   help="GPT-2-small width (d768 L12 H12, vocab 50257) + the in-repo BPE tokenizer")
    p.add_argument("--tokenizer", choices=["byte", "bpe"], default=None)
    p.add_argument("--bpe-vocab", type=int, default=1024)
    p.add_argument("--device", type=str, default="cuda", help="cuda (the card) or cpu (the plain path)")
    args = p.parse_args(argv)
    if args.gpt2_small:
        args.hidden, args.layers, args.heads = 768, 12, 12
        if args.tokenizer is None:
            args.tokenizer = "bpe"
    if args.lr is None:
        args.lr = 3e-4 if args.gpt2_small else 1e-3
    if args.tokenizer is None:
        args.tokenizer = "byte"
    return args


class Replay(NamedTuple):
    """Initial weights: the trunk BC starts from and the (q1, q2, v) heads
    value learning starts from (q2 and v unused by MC, v by CQL)."""

    trunk: torch.nn.Module
    heads: Tuple[torch.nn.Module, torch.nn.Module, torch.nn.Module]


def draw_initial_weights(config, value_bias_init: float, device, seed: int = 0) -> Replay:
    """Torch draws of the initial weights: the trunk from `seed`, the q1,
    q2 and v MLP heads (hidden 2·D, second layer zero, its bias
    `value_bias_init`) from seed + 2, + 3, + 4."""
    from lmrl_gym_torch.models.heads import MLPHead, MLPHeadConfig
    from lmrl_gym_torch.models.transformer import init_params

    D = config.hidden_size
    kw = dict(input_dim=D, hidden_dim=2 * D, layer2_initializer_range=0.0, layer2_bias_init=value_bias_init)
    q_cfg = MLPHeadConfig(output_dim=config.padded_vocab_size, **kw)
    heads = (MLPHead(q_cfg, device=device, seed=seed + 2), MLPHead(q_cfg, device=device, seed=seed + 3),
             MLPHead(MLPHeadConfig(output_dim=1, **kw), device=device, seed=seed + 4))
    return Replay(init_params(config, seed=seed, device=device), heads)


class Gate:
    """The gate's data, model and eval harness, built from its flags; one
    method per stage. `dtype` is the trunk's activation dtype (bf16, as
    the JAX gate runs)."""

    def __init__(self, args: argparse.Namespace, dtype: str = "bfloat16", replay: Optional[Replay] = None):
        from lmrl_gym_torch.algos.value_policy import LMServer, ValueGuidedServer
        from lmrl_gym_torch.core.blocking import BlockingStrategy, Padding, Truncation
        from lmrl_gym_torch.core.device import resolve_device
        from lmrl_gym_torch.envs.maze.grids import double_t_maze
        from lmrl_gym_torch.models.config import TransformerConfig
        from lmrl_gym_torch.models.generation import SamplingConfig
        from lmrl_gym_torch.models.interface import LMCore
        from lmrl_gym_torch.text.tokenizer import ByteTokenizer

        self.args = args
        self._initial = replay  # the initial weights, replayed or drawn on first use
        self.device = resolve_device(args.device)
        self.t_start = time.time()
        if args.tokenizer == "bpe":
            from lmrl_gym_torch.text.bpe import train_bpe_for_task

            self.tokenizer = train_bpe_for_task("maze", vocab_size=args.bpe_vocab, n_episodes=100, seed=0)
            eos_id = self.tokenizer.newline_token_id
        else:
            self.tokenizer = ByteTokenizer()
            eos_id = 10
        # --gpt2-small: the model's vocab is GPT-2's 50,257 ids though the
        # task BPE fills only the low ones; the embedding and softmax cost
        # is what defines that operating point
        model_vocab = 50257 if args.gpt2_small else self.tokenizer.vocab_size
        self.config = TransformerConfig(
            vocab_size=model_vocab, hidden_size=args.hidden, num_layers=args.layers, num_heads=args.heads,
            max_position_embeddings=256, pad_vocab_to_multiple=128 if args.gpt2_small else 64,
            embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype=dtype,
        )
        self.core = LMCore(self.config, device=self.device)
        self.maze = double_t_maze()
        self.strategy = BlockingStrategy(Padding.RIGHT, Truncation.RIGHT, MAX_LEN)
        self.sampling = SamplingConfig(max_new_tokens=12, greedy=True, eos_token_id=eos_id,
                                       pad_token_id=self.tokenizer.pad_token_id)
        self.server = LMServer(self.core, self.tokenizer)
        self.guided = ValueGuidedServer(self.core, self.tokenizer, beta=args.beta, share_trunk=False)
        # one numpy stream orders every epoch's batches, BC's and then the
        # value stage's, as in the JAX gate
        self.rng = np.random.default_rng(0)

    def log(self, msg: str) -> None:
        print(f"{msg} ({time.time() - self.t_start:.0f}s)", flush=True)

    def _tensors(self, b: dict, **dtypes) -> dict:
        return {k: torch.from_numpy(np.asarray(b[k])).to(self.device, dt) for k, dt in dtypes.items()}

    def initial_weights(self) -> Replay:
        """The initial trunk and (q1, q2, v) heads, drawn once: the replayed
        ones, else `draw_initial_weights`'s."""
        if self._initial is None:
            self._initial = draw_initial_weights(self.config, self.args.value_bias_init, self.device)
        return self._initial

    # ---- data
    def token_chains(self):
        from lmrl_gym_torch.cli.tasks import generate_maze_chains
        from lmrl_gym_torch.text.frames import TokenTrajectoryChain

        args = self.args
        chains = generate_maze_chains(args.n_chains, seed=args.seed, p_optimal=args.p_optimal, wrong_bias=True)
        return [TokenTrajectoryChain.from_text_trajectory_chain(c, self.tokenizer) for c in chains]

    # ---- stage 1: BC pretraining
    def train_bc(self, token_chains):
        """--bc-epochs over every chain window; returns (params, last loss)."""
        from lmrl_gym_torch.algos import data as algo_data
        from lmrl_gym_torch.algos.bc import BCBatch, BCConfig, BCTrainState, make_bc_train_step
        from lmrl_gym_torch.core.optimizer import OptimizerConfig, TrainState, make_optimizer

        args = self.args
        windows = [tt for c in token_chains for tt in c.to_list()]
        examples = [algo_data.BCExample.from_segments(tt.tokens, tt.is_action) for tt in windows]
        dataset = algo_data.ArrayDataset(
            algo_data.block_bc_examples(examples, self.strategy, self.tokenizer.pad_token_id))
        params = copy.deepcopy(self.initial_weights().trunk)
        state = BCTrainState(TrainState(params, make_optimizer(OptimizerConfig(lr=args.lr), params)))
        step = make_bc_train_step(self.core, BCConfig(), self.tokenizer.pad_token_id)
        loss = torch.zeros(())
        for _ in range(args.bc_epochs):
            for b in dataset.batches(args.bsize, rng=self.rng, drop_last=False):
                t = self._tensors(b, input_ids=torch.long, training_mask=torch.float32)
                state, loss, _ = step(state, BCBatch(t["input_ids"], t["training_mask"]))
        return state.model.params, float(loss)

    def accuracy(self, act) -> float:
        from lmrl_gym_torch.envs.maze.eval import per_cell_optimal_move_accuracy

        acc, _ = per_cell_optimal_move_accuracy(act, self.maze, GOAL)
        return acc

    def bc_accuracy(self, bc_params) -> float:
        """BC's greedy per-cell accuracy through `LMServer`."""
        from lmrl_gym_torch.text.frames import Text

        def act(histories):
            prompts = ["".join(t.text for t in h) for h in histories]
            outs = self.server.generate_from_strs(bc_params, prompts, MAX_LEN, self.sampling)
            return [h + (Text(o, True),) for h, o in zip(histories, outs)]

        return self.accuracy(act)

    # ---- stage 2: offline value learning from the BC trunk
    def value_dataset(self, token_chains):
        from lmrl_gym_torch.algos import data as algo_data

        args, pad = self.args, self.tokenizer.pad_token_id
        examples = []
        for c in token_chains:
            curr = c
            while curr is not None:
                if args.algo == "mc":
                    examples.append(algo_data.MCExample.from_chain(curr, args.gamma))
                else:
                    examples.append(algo_data.ILQLExample.from_chain(curr))
                curr = curr.next
        if args.algo == "mc":
            return algo_data.ArrayDataset(algo_data.block_mc_examples(examples, self.strategy, pad)), len(examples)
        return algo_data.ArrayDataset(algo_data.block_ilql_examples(examples, self.strategy, pad)), len(examples)

    def init_value_state(self, bc_params, n_examples: int):
        """The --algo state on a copy of the BC trunk and copies of the
        initial heads; returns (state, train_step)."""
        from lmrl_gym_torch.core import optimizer as opt

        args = self.args
        q1, q2, v = (copy.deepcopy(h) for h in self.initial_weights().heads)

        n_batches_per_epoch = -(-n_examples // args.bsize)
        total_updates = max(1, args.ilql_epochs * n_batches_per_epoch // max(1, args.grad_accum))
        head_lr = opt.cosine_decay_schedule(args.lr, total_updates) if args.lr_warmdown else args.lr
        base_tx = opt.set_to_zero() if args.freeze_base else opt.adamw(args.lr * 0.3)
        head_tx = opt.adamw(head_lr)
        if args.grad_accum > 1:
            head_tx = opt.multi_steps(head_tx, every_k_schedule=args.grad_accum)
            if not args.freeze_base:
                base_tx = opt.multi_steps(base_tx, every_k_schedule=args.grad_accum)
        base = copy.deepcopy(bc_params)
        pad = self.tokenizer.pad_token_id

        if args.algo == "ilql":
            from lmrl_gym_torch.algos.ilql import ILQLConfig, init_ilql_state, make_ilql_train_step

            config = ILQLConfig(use_separate_target_base=not args.freeze_base, polyak_alpha=args.polyak,
                                freeze_base=args.freeze_base, gamma=args.gamma)
            state = init_ilql_state(base, q1, q2, v, base_tx, head_tx, config)
            return state, make_ilql_train_step(self.core, config, pad)
        if args.algo == "cql":
            from lmrl_gym_torch.algos.cql import CQLConfig, init_cql_state, make_cql_train_step

            config = CQLConfig(gamma=args.gamma, polyak_alpha=args.polyak,
                               use_separate_target_base=not args.freeze_base)
            return init_cql_state(base, q1, q2, base_tx, head_tx, config), make_cql_train_step(self.core, config, pad)
        from lmrl_gym_torch.algos.mc import MCConfig, MCTrainState, make_mc_train_step

        state = MCTrainState(base=opt.TrainState(base, base_tx), q_head=opt.TrainState(q1, head_tx))
        return state, make_mc_train_step(self.core, MCConfig(gamma=args.gamma), pad)

    def make_batch(self, b: dict):
        if self.args.algo == "mc":
            from lmrl_gym_torch.algos.mc import MCBatch

            t = self._tensors(b, input_ids=torch.long, should_take_action=torch.bool, returns=torch.float32)
            return MCBatch(t["input_ids"], t["should_take_action"], t["returns"])
        from lmrl_gym_torch.algos.ilql import ILQLBatch

        t = self._tensors(b, input_ids=torch.long, should_take_action=torch.bool, rewards=torch.float32,
                          dones=torch.bool, next_token_ids=torch.long, next_dones=torch.bool)
        return ILQLBatch(t["input_ids"], t["should_take_action"], t["rewards"], t["dones"],
                         t["next_token_ids"], t["next_dones"])

    def train_epoch(self, state, train_step, dataset):
        loss, logs = None, None
        for b in dataset.batches(self.args.bsize, rng=self.rng, drop_last=False):
            state, loss, logs = train_step(state, self.make_batch(b))
        return state, loss, logs

    # ---- evals
    def heads_of(self, state, use_target: bool):
        """(q1, q2, v) per algo; use_target swaps in the polyak heads where
        the algo keeps them (MC has none)."""
        algo = self.args.algo
        if algo == "ilql":
            if use_target:
                return state.q1_target_params, state.q2_target_params, state.v_head.params
            return state.q1_head.params, state.q2_head.params, state.v_head.params
        if algo == "cql":
            if use_target:
                return state.q1_target_params, state.q2_target_params, None
            return state.q1_head.params, state.q2_head.params, None
        return state.q_head.params, None, None

    def guided_accuracy(self, state, bc_params) -> float:
        from lmrl_gym_torch.algos.value_policy import ValueRLParams
        from lmrl_gym_torch.text.frames import Text

        args = self.args
        q1, q2, v = self.heads_of(state, args.eval_heads == "target")
        bundle = ValueRLParams(pi_beta=bc_params, base=state.base.params, q1_head=q1, q2_head=q2, v_head=v)

        def act(histories):
            prompts = ["".join(t.text for t in h) for h in histories]
            if args.guided_legal:
                outs = self.guided.generate_from_strs_legal(
                    bundle, prompts, [ACTION_PROPOSALS] * len(prompts), MAX_LEN, self.sampling,
                    max_proposals=4, max_proposal_len=16,
                )
            else:
                outs = self.guided.generate_from_strs(bundle, prompts, MAX_LEN, self.sampling)
            return [h + (Text(o, True),) for h, o in zip(histories, outs)]

        return self.accuracy(act)

    def reranker_accuracy(self, state, use_target: bool = False) -> float:
        """The four move proposals scored by Σ(min(Q1,Q2) − V) (ILQL) or by
        the mean Q over the action tokens (MC, CQL), through the online or
        the target heads."""
        from lmrl_gym_torch.algos.value_policy import (
            ReRankerPolicy,
            ValueRLParams,
            make_ilql_score_fn,
            make_mc_score_fn,
            tokenize_histories_for_scoring,
        )
        from lmrl_gym_torch.envs.maze.grids import ACTION_STRS
        from lmrl_gym_torch.text.frames import Text

        q1, q2, v = self.heads_of(state, use_target)
        bundle = ValueRLParams(pi_beta=None, base=state.base.params, q1_head=q1, q2_head=q2, v_head=v)
        pad = self.tokenizer.pad_token_id
        if self.args.algo == "ilql":
            score = make_ilql_score_fn(self.core, bundle, pad)
        else:
            # byte-tokenizer proposals are 8-11 tokens: mean Q, not Σ Q
            score = make_mc_score_fn(self.core, bundle, pad, length_normalize=True)

        def proposal_fn(history):
            return [history + (Text(a, True),) for a in ACTION_STRS]

        def score_batch(histories):
            ids, am = tokenize_histories_for_scoring(histories, self.tokenizer, MAX_LEN, device=self.device)
            return score(ids, am).cpu().numpy()

        policy = ReRankerPolicy(proposal_fn=proposal_fn, score_batch=score_batch)
        return self.accuracy(lambda hs: policy.act(hs))


def run(g: Gate) -> dict:
    """Every stage in the JAX gate's order; returns its JSON result."""
    args = g.args
    g.log(f"model: d{args.hidden} L{args.layers} H{args.heads} vocab{g.config.vocab_size} "
          f"tokenizer={args.tokenizer}({g.tokenizer.vocab_size}) on {g.device.type}")
    g.log(f"data: {args.n_chains} chains, p_optimal={args.p_optimal} wrong-biased")
    token_chains = g.token_chains()

    bc_params, bc_loss = g.train_bc(token_chains)
    bc_acc = g.bc_accuracy(bc_params)
    g.log(f"BC greedy per-cell accuracy: {bc_acc:.3f} (bc loss {bc_loss:.3f})")

    dataset, n_examples = g.value_dataset(token_chains)
    state, train_step = g.init_value_state(bc_params, n_examples)
    curve = [dict(epoch=0, acc=bc_acc, kind="bc")]
    for epoch in range(1, args.ilql_epochs + 1):
        state, loss, logs = g.train_epoch(state, train_step, dataset)
        if epoch % args.eval_every == 0 or epoch == args.ilql_epochs:
            acc = g.guided_accuracy(state, bc_params)
            racc = g.reranker_accuracy(state)
            tacc = g.reranker_accuracy(state, use_target=True)
            qkey = "q1" if "q1" in logs else "q"
            loss_bits = " ".join(f"{k} {float(v):.3f}" for k, v in sorted(logs["losses"].items()))
            vm = float(logs["v"]["mean"]) if "v" in logs else float("nan")
            g.log(f"epoch {epoch:3d}: loss {float(loss):8.3f} [{loss_bits}] q~{float(logs[qkey]['mean']):.2f} "
                  f"v~{vm:.2f} guided acc {acc:.3f}  rerank acc {racc:.3f}  target-rerank {tacc:.3f}")
            curve.append(dict(epoch=epoch, acc=acc, rerank_acc=racc, target_rerank_acc=tacc,
                              kind=f"{args.algo}_guided"))
    return dict(bc_acc=bc_acc, curve=curve)


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
