"""Standalone checkpoint evaluation CLI: the port of
`lmrl_gym_tpu/cli/evaluate.py`, with the same flags plus `--device`.
Reload a checkpoint (written by either package's `cli.train`), rebuild the
serving policy, run text_env_eval.

    python -m lmrl_gym_torch.cli.evaluate --task maze --algo ilql \\
        --checkpoint outputs/maze_ilql/best --n-rollouts 32

Policy kinds:
  generate  plain LM sampling from base params (BC/PPO checkpoints)
  guided    β-perturbed value-guided decoding (ILQL/CQL/MC checkpoints)
  reranker  score a task proposal set with the algo's score fn and argmax
            (maze's 4-move proposal set)
  human     a person at the terminal (`envs/human.py`)
  api       a chat API (`envs/api_policy.py`)

Task extras: maze adds per-cell optimal-move accuracy vs the BFS table;
chess adds the positional victories/%-illegal harness.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from lmrl_gym_torch.algos.value_policy import (
    GenerationPolicy,
    LMServer,
    ReRankerPolicy,
    ValueGuidedServer,
    ValueRLParams,
    make_ilql_score_fn,
    make_logprob_score_fn,
    make_mc_score_fn,
    tokenize_histories_for_scoring,
)
from lmrl_gym_torch.cli.tasks import TASKS
from lmrl_gym_torch.cli.train import ALGOS, MODEL_SIZES, build_head, check_mesh
from lmrl_gym_torch.core.device import resolve_device
from lmrl_gym_torch.envs.base import text_env_eval
from lmrl_gym_torch.loops.checkpoints import load_module_config, restore_module
from lmrl_gym_torch.models.config import TransformerConfig
from lmrl_gym_torch.models.generation import SamplingConfig
from lmrl_gym_torch.models.interface import LMCore
from lmrl_gym_torch.models.transformer import init_params
from lmrl_gym_torch.text.frames import Text
from lmrl_gym_torch.text.tokenizer import load_tokenizer, newline_id


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--task", choices=sorted(TASKS), required=True)
    p.add_argument(
        "--algo",
        choices=ALGOS,
        default=None,
        help="algorithm that produced the checkpoint (selects module "
             "layout); default: inferred from which head modules exist in "
             "the checkpoint dir; irrelevant for --policy human|api",
    )
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint dir (module subdirs), or a save_dir "
                        "containing best/ / epoch_N/ (latest wins)")
    p.add_argument("--policy",
                   choices=["generate", "guided", "reranker", "human", "api"],
                   default=None,
                   help="default: guided for value algos, generate otherwise; "
                        "human/api are checkpoint-free baselines")
    p.add_argument("--api-model", type=str, default="gpt-4",
                   help="chat model for --policy api (OPENAI_API_KEY / "
                        "OPENAI_BASE_URL env vars select the endpoint)")
    p.add_argument("--model-size", choices=sorted(MODEL_SIZES), default="tiny",
                   help="fallback when the checkpoint has no base/config.json")
    p.add_argument("--mesh", type=str, default="1,-1,1")
    p.add_argument(
        "--tokenizer", type=str, default="byte",
        help="byte | bpe:<path> | HF name/path (must match training)",
    )
    p.add_argument("--n-rollouts", type=int, default=32)
    p.add_argument("--bsize", type=int, default=8)
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--max-length", type=int, default=None)
    p.add_argument("--beta", type=float, default=8.0)
    p.add_argument("--greedy", action="store_true", default=True)
    p.add_argument("--sample", dest="greedy", action="store_false")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default=None, help="write summary JSON here")
    # chess positional eval
    p.add_argument("--chess-positions", type=int, default=0,
                   help="maze-free chess extra: eval N random endgame positions")
    p.add_argument(
        "--no-cell-accuracy", action="store_true",
        help="maze: skip the per-cell optimal-move sweep after rollouts "
             "(it is ~100 extra policy calls — billable for --policy api, "
             "interactive for --policy human, where it is skipped by "
             "default)",
    )
    p.add_argument("--device", type=str, default="cuda", help="cuda (the card) or cpu (the plain path)")
    return p.parse_args(argv)


def has_module(ckpt_dir: str, name: str) -> bool:
    d = os.path.join(ckpt_dir, name)
    return os.path.exists(os.path.join(d, "params.msgpack")) or os.path.exists(
        os.path.join(d, "train_state.msgpack")
    )


def infer_algo(ckpt_dir: str) -> str:
    """Infer the producing algorithm from the checkpoint's module layout,
    so evaluating a value checkpoint without --algo cannot silently degrade
    to a plain BC policy (base/ exists in every layout)."""
    if has_module(ckpt_dir, "v_head") and has_module(ckpt_dir, "q1_head"):
        return "ilql"
    if has_module(ckpt_dir, "q1_head"):  # twin-Q, no V
        return "cql"
    if has_module(ckpt_dir, "q_head"):  # single Q = MC-returns
        return "mc"
    if has_module(ckpt_dir, "value_head"):
        return "ppo"
    return "bc"


def resolve_checkpoint_dir(path: str) -> str:
    # PPO checkpoints name their trunk module "policy"; every other
    # algorithm uses "base"
    def has_trunk(d):
        return os.path.isdir(os.path.join(d, "base")) or os.path.isdir(os.path.join(d, "policy"))

    if has_trunk(path):
        return path
    for tag in ("best", "last"):
        if has_trunk(os.path.join(path, tag)):
            return os.path.join(path, tag)
    epochs = sorted(
        (d for d in os.listdir(path) if d.startswith(("epoch_", "step_", "round_"))),
        key=lambda d: int(d.split("_")[-1]),
    )
    if epochs:
        return os.path.join(path, epochs[-1])
    raise FileNotFoundError(f"no checkpoint modules under {path}")


def load_config(ckpt_dir: str, fallback_size: str) -> TransformerConfig:
    for module in ("base", "policy"):
        try:
            return TransformerConfig.from_dict(load_module_config(ckpt_dir, module))
        except FileNotFoundError:
            continue
    return MODEL_SIZES[fallback_size]()


def build_eval_policy(args, ckpt_dir, config, tokenizer, core, max_length):
    """Rebuild the serve path for the checkpoint's module layout; every
    module is read through `loops/checkpoints.py::restore_module`."""
    device = core.device
    trunk_module = "policy" if has_module(ckpt_dir, "policy") else "base"
    base = restore_module(ckpt_dir, trunk_module, init_params(config, seed=args.seed, device=device))

    value_algo = args.algo in ("ilql", "mc", "cql")
    kind = args.policy or ("guided" if value_algo else "generate")

    sampling = SamplingConfig(
        max_new_tokens=args.max_new_tokens,
        greedy=args.greedy,
        eos_token_id=newline_id(tokenizer),
        pad_token_id=tokenizer.pad_token_id,
    )
    generator = torch.Generator(device=device).manual_seed(args.seed + 999)

    q1 = q2 = v_head = None
    if value_algo:
        q1_name = "q_head" if args.algo == "mc" else "q1_head"
        q1 = restore_module(ckpt_dir, q1_name, build_head("mlp", config, device, args.seed)[0])
        if has_module(ckpt_dir, "q2_head"):
            q2 = restore_module(ckpt_dir, "q2_head", build_head("mlp", config, device, args.seed)[0])
        if has_module(ckpt_dir, "v_head"):
            v_head = restore_module(ckpt_dir, "v_head", build_head("mlp", config, device, args.seed, output_dim=1)[0])
    bundle = ValueRLParams(pi_beta=None, base=base, q1_head=q1, q2_head=q2, v_head=v_head)

    if kind in ("generate", "guided"):
        if kind == "generate":
            server, params = LMServer(core, tokenizer), base
        else:
            assert value_algo, "--policy guided needs an ilql/cql/mc checkpoint"
            server, params = ValueGuidedServer(core, tokenizer, beta=args.beta, share_trunk=True), bundle

        def generate_batch(prompts, gen):
            outs = server.generate_from_strs(params, prompts, max_length, sampling, gen)
            return [p + o for p, o in zip(prompts, outs)]

        return GenerationPolicy(generate_batch=generate_batch, generator=generator)

    # reranker: task proposal set scored by the algo's score fn
    if args.task != "maze":
        raise NotImplementedError(
            "reranker proposals are defined for maze (the reference's 4-move "
            "proposal set, maze/env/env.py:101-102)"
        )
    from lmrl_gym_torch.envs.maze.grids import ACTION_STRS

    if args.algo == "ilql":
        score = make_ilql_score_fn(core, bundle, tokenizer.pad_token_id)
    elif args.algo in ("mc", "cql"):
        score = make_mc_score_fn(core, bundle, tokenizer.pad_token_id)
    else:
        score = make_logprob_score_fn(core, base, tokenizer.pad_token_id)

    def proposal_fn(history):
        return [history + (Text(a, True),) for a in ACTION_STRS]

    def score_batch(histories):
        ids, am = tokenize_histories_for_scoring(histories, tokenizer, max_length, device)
        return score(ids, am).float().cpu().numpy()

    return ReRankerPolicy(proposal_fn=proposal_fn, score_batch=score_batch)


def build_external_policy(args):
    """Checkpoint-free baselines: a human at the terminal or a chat API."""
    if args.policy == "human":
        from lmrl_gym_torch.envs.human import HumanPolicy

        return HumanPolicy()
    from lmrl_gym_torch.envs.api_policy import APIChatPolicy, openai_chat_transport, task_instructions

    return APIChatPolicy(openai_chat_transport(model=args.api_model), instructions=task_instructions(args.task))


def main(argv=None):
    args = parse_args(argv)
    check_mesh(args.mesh)
    task = TASKS[args.task]
    max_length = args.max_length or task.max_length

    if args.policy in ("human", "api"):
        print(f"evaluating {args.policy} baseline on {args.task}")
        policy = build_external_policy(args)
        if args.policy == "human":
            # one HumanPolicy has one transcript/prompt state; batched slots
            # would interleave episodes through it
            args.bsize = 1
    else:
        device = resolve_device(args.device)
        if args.checkpoint is None:
            raise SystemExit("--checkpoint is required unless --policy human|api")
        ckpt_dir = resolve_checkpoint_dir(args.checkpoint)
        if args.algo is None:
            args.algo = infer_algo(ckpt_dir)
            print(f"inferred --algo {args.algo} from checkpoint module layout")
        print(f"evaluating {ckpt_dir} on {args.task} ({args.algo})")

        tokenizer = load_tokenizer(args.tokenizer)
        config = load_config(ckpt_dir, args.model_size)
        core = LMCore(config, device=device)
        policy = build_eval_policy(args, ckpt_dir, config, tokenizer, core, max_length)

    env = task.build_env()
    _, summary = text_env_eval(
        env,
        policy,
        n_rollouts=args.n_rollouts,
        seed_generator=iter(range(10_000, 10_000 + args.n_rollouts)),
        bsize=min(args.n_rollouts, args.bsize),
    )
    results = {"rollouts": summary}

    skip_cell_sweep = args.no_cell_accuracy or args.policy == "human"
    if args.task == "maze" and not skip_cell_sweep:
        from lmrl_gym_torch.envs.base import TextPolicy
        from lmrl_gym_torch.envs.maze.eval import per_cell_optimal_move_accuracy, render_accuracy_grid
        from lmrl_gym_torch.envs.maze.grids import DOUBLE_T_GOAL, double_t_maze

        if isinstance(policy, TextPolicy):  # per-history baselines
            act = lambda hs: [policy.act(h) for h in hs]  # noqa: E731
        else:
            act = lambda hs: policy.act(hs)  # noqa: E731
        maze = double_t_maze()
        acc, per_cell = per_cell_optimal_move_accuracy(act, maze, DOUBLE_T_GOAL, bsize=args.bsize)
        print(render_accuracy_grid(maze, DOUBLE_T_GOAL, per_cell))
        print(f"per-cell optimal-move accuracy: {acc:.3f}")
        results["optimal_move_accuracy"] = acc

    if args.task == "chess" and args.chess_positions > 0:
        import random as _random

        from lmrl_gym_torch.envs.chess.env import large_piece_random_endgame, text_env_eval_chess_positions

        rng = _random.Random(args.seed)
        positions = [large_piece_random_endgame("kQK", rng) for _ in range(args.chess_positions)]
        _, chess_summary = text_env_eval_chess_positions(positions, policy, n_rollouts=1, bsize=args.bsize)
        results["positions"] = chess_summary
        print(json.dumps(chess_summary, indent=2, default=float))

    print(json.dumps(results, indent=2, default=float))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2, default=float)
    return results


if __name__ == "__main__":
    main()
