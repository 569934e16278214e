"""Unified training CLI: the port of `lmrl_gym_tpu/cli/train.py`, with the
same flags plus `--device`.

    python -m lmrl_gym_torch.cli.train --task maze --algo bc --n-data 200 \\
        --epochs 4 --model-size tiny --save-dir outputs/maze_bc
    python -m lmrl_gym_torch.cli.train ... --device cpu   # plain path, no card

Covers every task × {bc, filtered_bc, ilql, mc, cql, ppo} with scripted-
policy behavior data, periodic env-rollout eval through the serve path,
and checkpoints in the JAX package's layout (module names, flax key paths,
`config.json`, `loop_state.pkl`), so each package's `cli.evaluate` reads
the other's.

Draws: the initial modules come from the port's initialisers seeded from
`--seed` (trunk `seed`, heads `seed + 1, ...`), and sampled serving calls
from `torch.Generator`s seeded as the JAX CLI seeds its keys. `main(argv,
replay=Replay(...))` takes another run's initial modules and the Gumbel
noise of its sampled serving calls instead.

`--mesh dp,fsdp,mp` (default `1,-1,1`) lays a mesh over the ranks of the
process group that `torchrun` starts (`core/io.py::distributed_init`; one
process and one card per rank, NCCL on the card, gloo with `--device
cpu`): every module is sharded by its rule table (FSDP2) and each rank
trains on its rows of every batch (`parallel/mesh.py`). Without `torchrun`
the run is one rank, and a shape that does not fit the world size raises.

    torchrun --nproc_per_node 2 -m lmrl_gym_torch.cli.train --task maze \
        --algo ilql --model-size tiny --mesh 1,2,1 --device cpu --save-dir out
"""
from __future__ import annotations

import argparse
import copy
import os
from typing import Dict, Iterator, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from lmrl_gym_torch.algos import data as algo_data
from lmrl_gym_torch.algos.value_policy import GenerationPolicy, LMServer, ValueGuidedServer, ValueRLParams
from lmrl_gym_torch.cli.tasks import TASKS
from lmrl_gym_torch.core.blocking import BlockingStrategy, Padding, Truncation
from lmrl_gym_torch.core.device import resolve_device
from lmrl_gym_torch.core.experiment import setup_experiment_save, uuid_name
from lmrl_gym_torch.core.io import distributed_init, is_main_process
from lmrl_gym_torch.core.optimizer import OptimizerConfig, TrainState, make_optimizer
from lmrl_gym_torch.envs.base import text_env_eval
from lmrl_gym_torch.loops.offline import OfflineLoopConfig, offline_train_loop
from lmrl_gym_torch.loops.online import OnlineLoopConfig, online_train_loop
from lmrl_gym_torch.models.config import TransformerConfig, gpt2_medium, gpt2_small, tiny_test_config
from lmrl_gym_torch.models.generation import SamplingConfig
from lmrl_gym_torch.models.heads import LinearHead, LinearHeadConfig, MLPHead, MLPHeadConfig
from lmrl_gym_torch.models.interface import LMCore
from lmrl_gym_torch.models.transformer import init_params
from lmrl_gym_torch.parallel.mesh import Mesh, load_mesh, shard_module, shard_train_state
from lmrl_gym_torch.text.frames import TokenTrajectoryChain
from lmrl_gym_torch.text.tokenizer import load_tokenizer, newline_id

ALGOS = ["bc", "filtered_bc", "ilql", "mc", "cql", "ppo"]

MODEL_SIZES = {
    "tiny": lambda: tiny_test_config(
        hidden_size=128, num_layers=4, num_heads=4, max_position_embeddings=1280
    ),
    "small": lambda: TransformerConfig(
        vocab_size=259,
        hidden_size=512,
        num_layers=8,
        num_heads=8,
        max_position_embeddings=1280,
        pad_vocab_to_multiple=64,
        embd_pdrop=0.0,
        resid_pdrop=0.0,
        attn_pdrop=0.0,
    ),
    "gpt2-small": lambda: gpt2_small().replace(vocab_size=259, pad_vocab_to_multiple=64),
    "gpt2-medium": lambda: gpt2_medium().replace(vocab_size=259, pad_vocab_to_multiple=64),
    # the reference operating point: the full 50,257-token vocabulary. Pair
    # with --tokenizer bpe; the task BPE populates the low id range and the
    # model carries the real embedding/softmax cost.
    "gpt2-small-real": lambda: gpt2_small(),
    "gpt2-medium-real": lambda: gpt2_medium(),
}


class Replay(NamedTuple):
    """Another run's draws: initial modules by checkpoint name (`base`,
    `q1_head`, `q2_head`, `v_head`, `q_head`, `policy`, `value_head`), and
    the Gumbel noise [max_new_tokens, B, V] of each sampled serving call in
    order (greedy calls draw none)."""

    modules: Dict[str, nn.Module]
    gumbels: Optional[Iterator[torch.Tensor]] = None


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--task", choices=sorted(TASKS), required=True)
    p.add_argument("--algo", choices=ALGOS, required=True)
    p.add_argument("--model-size", choices=sorted(MODEL_SIZES), default="tiny")
    p.add_argument(
        "--tokenizer",
        type=str,
        default="byte",
        help=(
            "byte | bpe (train on this task's data, saved to save_dir) | "
            "bpe:<path> (saved vocab) | HF name/path (local cache only)"
        ),
    )
    p.add_argument("--bpe-vocab-size", type=int, default=2048)
    p.add_argument("--n-data", type=int, default=200, help="episodes of behavior data")
    p.add_argument(
        "--data-jsonl", type=str, default=None,
        help="BC only: stream behavior data from a segments-jsonl file "
        "instead of holding it in memory; each line = [[text, is_action], ...]",
    )
    p.add_argument(
        "--dump-data-jsonl", type=str, default=None,
        help="write the generated behavior data to a segments-jsonl file",
    )
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--train-bsize", type=int, default=16)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--head-lr", type=float, default=1e-3)
    p.add_argument("--max-length", type=int, default=None)
    p.add_argument("--mesh", type=str, default="1,-1,1", help="dp,fsdp,mp over the torchrun ranks (-1: the rest)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save-dir", type=str, default=None)
    p.add_argument("--exp-name", type=str, default=None)
    p.add_argument("--eval-rollouts", type=int, default=8)
    p.add_argument("--eval-every-epochs", type=int, default=1)
    p.add_argument("--eval-max-new-tokens", type=int, default=32)
    p.add_argument("--log-every", type=int, default=64)
    # algo knobs
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--tau", type=float, default=0.7)
    p.add_argument("--cql-weight", type=float, default=0.01)
    p.add_argument("--beta", type=float, default=8.0)
    p.add_argument("--polyak-alpha", type=float, default=0.005)
    p.add_argument("--filter-top-frac", type=float, default=0.3)
    p.add_argument("--ppo-kl-weight", type=float, default=0.01)
    p.add_argument(
        "--ppo-kl-target", type=float, default=None,
        help="adaptive KL controller target (None = fixed kl weight)",
    )
    p.add_argument("--ppo-kl-horizon", type=float, default=10000.0)
    p.add_argument("--ppo-lam", type=float, default=0.95)
    p.add_argument(
        "--ppo-value-bias-init", type=float, default=0.0,
        help="value-head bias init (reference wordle PPO uses -4.1)",
    )
    p.add_argument(
        "--bc-loss-weight", type=float, default=0.0,
        help="mix a masked-BC loss on behavior data into each PPO step",
    )
    p.add_argument(
        "--resume", type=str, default=None,
        help="checkpoint dir to resume from (policy/value_head + loop_state)",
    )
    p.add_argument("--no-eval", action="store_true")
    # online (round-based) mode: fresh rollouts with the live policy each
    # round (PPO, online ILQL / CQL, online filtered BC). 0 = offline.
    p.add_argument("--online-rounds", type=int, default=0)
    p.add_argument("--rollouts-per-round", type=int, default=32)
    p.add_argument("--rollout-bsize", type=int, default=8)
    p.add_argument("--rollout-temperature", type=float, default=1.0)
    # LM-in-the-loop oracles for the dialog tasks: 'lm' loads
    # --oracle-checkpoint or BC-trains one from the scripted teacher first.
    p.add_argument("--oracle", choices=["scripted", "lm"], default="scripted")
    p.add_argument(
        "--oracle-arch", choices=["decoder", "t5"], default="decoder",
        help="t5 = seq2seq oracle (reference flan-t5 role; Q/A tasks only)",
    )
    p.add_argument("--oracle-checkpoint", type=str, default=None)
    p.add_argument("--oracle-episodes", type=int, default=200)
    p.add_argument("--oracle-epochs", type=int, default=4)
    p.add_argument("--device", type=str, default="cuda", help="cuda (the card) or cpu (the plain path)")
    return p.parse_args(argv)


def check_mesh(mesh: str, device=None) -> Mesh:
    """The `--mesh` shape over the process group's ranks (one rank when no
    group was started); a shape that does not fit the world size raises."""
    shape = [int(x) for x in mesh.split(",")]
    if any(n == 0 or n < -1 for n in shape):
        raise ValueError(f"--mesh {mesh}: axes are positive sizes or one -1")
    try:
        return load_mesh(shape, device=device)
    except ValueError as e:
        raise ValueError(f"--mesh {mesh}: {e}") from e


def start_ranks(args) -> None:
    """Join the `torchrun` group when there is one (nothing otherwise) and
    give every rank the same experiment name."""
    if not distributed_init(device=args.device):
        return
    if getattr(args, "save_dir", None) is not None and args.exp_name is None:
        name = [uuid_name("train")]
        dist.broadcast_object_list(name, src=0)
        args.exp_name = name[0]


def shard_state(state, core) -> None:
    """Every module of `state` sharded over the core's mesh (a no-op on one
    rank)."""
    if core.mesh is not None:
        shard_train_state(state, core.mesh)


def resolve_oracle_env(args, task, device, save_dir, mesh=None):
    """--oracle lm: swap the task's env builder for one that steps through
    a trained LM oracle/buyer on the device."""
    import dataclasses as _dc

    from lmrl_gym_torch.envs.lm_oracle import (
        COLLECTORS,
        LM_ENV_BUILDERS,
        OracleTrainConfig,
        load_oracle,
        train_and_save_oracle,
        train_oracle_lm,
        train_t5_oracle_lm,
    )

    assert task.name in LM_ENV_BUILDERS, (
        f"--oracle lm unsupported for task {task.name}; choose from {sorted(LM_ENV_BUILDERS)}"
    )
    if args.oracle_checkpoint:
        core_o, tok_o, params_o = load_oracle(args.oracle_checkpoint, device=device, mesh=mesh)
        print(f"loaded LM oracle from {args.oracle_checkpoint}")
    else:
        oracle_dir = os.path.join(save_dir, "oracle_lm") if save_dir else None
        cfg = OracleTrainConfig(n_episodes=args.oracle_episodes, epochs=args.oracle_epochs, seed=args.seed)
        print(f"training LM oracle for {task.name} ({cfg.n_episodes} episodes)...")
        if oracle_dir:
            core_o, tok_o, params_o = train_and_save_oracle(
                task.name, oracle_dir, cfg, arch=args.oracle_arch, device=device, mesh=mesh
            )
            print(f"saved LM oracle → {oracle_dir}")
        else:
            windows = COLLECTORS[task.name](cfg.n_episodes, cfg.seed)
            trainer = train_t5_oracle_lm if args.oracle_arch == "t5" else train_oracle_lm
            core_o, tok_o, params_o, _ = trainer(windows, cfg, device=device, mesh=mesh)

    builder = LM_ENV_BUILDERS[task.name]
    return _dc.replace(task, build_env=lambda **kw: builder(core_o, tok_o, params_o, **kw))


def build_tokenizer(args, save_dir=None):
    if args.tokenizer == "bpe":
        # trained on this task's own scripted-data distribution
        from lmrl_gym_torch.text.bpe import train_bpe_for_task

        path = os.path.join(save_dir, "bpe.json") if save_dir else None
        tok = train_bpe_for_task(args.task, vocab_size=args.bpe_vocab_size, seed=args.seed, save_path=path)
        print(f"trained BPE vocab={tok.vocab_size}" + (f" → {path}" if path else ""))
        return tok
    return load_tokenizer(args.tokenizer)


def build_model(args, device=None, save_dir=None, mesh=None):
    config = MODEL_SIZES[args.model_size]()
    tokenizer = build_tokenizer(args, save_dir)
    if config.vocab_size < tokenizer.vocab_size:
        config = config.replace(vocab_size=tokenizer.vocab_size)
    core = LMCore(config, device=device, mesh=mesh)
    return config, tokenizer, core


def build_head(kind: str, config, device, seed: int, output_dim: Optional[int] = None, bias_init: float = 0.0):
    """(head module, its config): an MLP Q/V head (layer 2 zero-initialised)
    or a linear value head, initialised from `seed` on `device`."""
    if kind == "mlp":
        head_cfg = MLPHeadConfig(
            input_dim=config.hidden_size,
            hidden_dim=2 * config.hidden_size,
            output_dim=output_dim or config.padded_vocab_size,
            layer2_initializer_range=0.0,
            layer2_bias_init=0.0,
        )
        return MLPHead(head_cfg, device=device, seed=seed), head_cfg
    head_cfg = LinearHeadConfig(input_dim=config.hidden_size, output_dim=output_dim or 1, bias_init=bias_init)
    return LinearHead(head_cfg, device=device, seed=seed), head_cfg


def _initial(replay: Optional[Replay], name: str, make, device):
    """The replayed initial module `name` on `device`, else `make()`."""
    if replay is not None and name in replay.modules:
        return replay.modules[name].to(device)
    return make()


def _device_steps(step, device, seed: int):
    """The loops hand each step a CPU generator; on the card the dropout
    masks are drawn there instead, from a device generator seeded as the
    loops seed theirs."""
    if device.type == "cpu":
        return step
    generator = torch.Generator(device=device).manual_seed(seed)
    return lambda state, batch, _loop_generator: step(state, batch, generator)


def _tensors(b, device, **dtypes):
    """The batch's arrays as device tensors (None stays None)."""
    return {
        k: None if b.get(k) is None else torch.as_tensor(np.asarray(b[k])).to(device, dtype)
        for k, dtype in dtypes.items()
    }


def make_generate(server, params_fn, max_len: int, sampling: SamplingConfig, replay: Optional[Replay]):
    """generate_batch(prompts, generator) for `GenerationPolicy`: the
    server's completions appended to their prompts; a sampled call takes
    the replay's next noise when there is one."""

    def generate_batch(prompts, generator):
        gumbel = None
        if replay is not None and replay.gumbels is not None and not sampling.greedy:
            gumbel = next(replay.gumbels).to(server.core.device)
        outs = server.generate_from_strs(params_fn(), prompts, max_len, sampling, generator, gumbel)
        return [p + o for p, o in zip(prompts, outs)]

    return generate_batch


def collect_rollout_chains(args, task, tokenizer, generate_batch, seed: int, device):
    """Fresh rollouts with the live policy → TextTrajectoryChains (the
    per-round dataset of the online loops)."""
    from lmrl_gym_torch.algos.ppo import fold_trajectory_to_length
    from lmrl_gym_torch.cli.tasks import transitions_to_chain
    from lmrl_gym_torch.text.frames import TextTrajectoryChain

    policy = GenerationPolicy(generate_batch=generate_batch,
                              generator=torch.Generator(device=device).manual_seed(seed))
    env = task.build_env()
    interactions, summary = text_env_eval(
        env,
        policy,
        n_rollouts=args.rollouts_per_round,
        seed_generator=iter(range(seed, seed + args.rollouts_per_round)),
        bsize=min(args.rollouts_per_round, args.rollout_bsize),
    )
    chains = [transitions_to_chain(t) for t in interactions]
    # fold single-window conversations that overflow the training window
    # (reward-folding truncation); multi-window chains are already windowed
    max_len = args.max_length or task.max_length
    chains = [
        TextTrajectoryChain(fold_trajectory_to_length(c.text_trajectory, tokenizer, max_len - 1, args.gamma), None)
        if c.next is None
        else c
        for c in chains
    ]
    return chains, summary


def make_rollout_sampling(args, tokenizer):
    return SamplingConfig(
        max_new_tokens=args.eval_max_new_tokens,
        temperature=args.rollout_temperature,
        greedy=False,
        eos_token_id=newline_id(tokenizer),
        pad_token_id=tokenizer.pad_token_id,
    )


def _greedy_sampling(args, tokenizer):
    return SamplingConfig(
        max_new_tokens=args.eval_max_new_tokens,
        greedy=True,
        eos_token_id=newline_id(tokenizer),
        pad_token_id=tokenizer.pad_token_id,
    )


def _eval_rollouts(args, task, generate_batch, seed: int, device):
    policy = GenerationPolicy(generate_batch=generate_batch,
                              generator=torch.Generator(device=device).manual_seed(seed))
    _, summary = text_env_eval(
        task.build_env(),
        policy,
        n_rollouts=args.eval_rollouts,
        seed_generator=iter(range(10_000, 10_000 + args.eval_rollouts)),
        bsize=min(args.eval_rollouts, 8),
    )
    return summary["reward"]["mean"], summary


def make_policy_evaluator(args, task, tokenizer, core, get_params):
    """Evaluator: env rollouts through the serve path; perf = mean reward."""
    server = LMServer(core, tokenizer)
    max_len = args.max_length or task.max_length
    sampling = _greedy_sampling(args, tokenizer)

    def evaluator(train_state):
        generate = make_generate(server, lambda: get_params(train_state), max_len, sampling, None)
        return _eval_rollouts(args, task, generate, args.seed + 1234, core.device)

    return evaluator


def main(argv=None, replay: Optional[Replay] = None):
    """Returns the run's (final train state, loop state)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    start_ranks(args)
    mesh = check_mesh(args.mesh, device)
    task = TASKS[args.task]
    max_length = args.max_length or task.max_length

    save_dir, exp_name = setup_experiment_save(args.exp_name, args.save_dir, vars(args), __file__,
                                               is_main_process=is_main_process())
    print(f"experiment: {exp_name} save_dir: {save_dir} mesh: {mesh.shape}")

    config, tokenizer, core = build_model(args, device=device, save_dir=save_dir, mesh=mesh)

    if args.oracle == "lm":
        task = resolve_oracle_env(args, task, device, save_dir, mesh)

    print(f"generating {args.n_data} behavior episodes for {args.task}...")
    chains = task.generate_chains(args.n_data, args.seed)
    if args.dump_data_jsonl:
        n = algo_data.dump_chains_to_segments_jsonl(chains, args.dump_data_jsonl)
        print(f"dumped {n} windows → {args.dump_data_jsonl}")
    token_chains = [TokenTrajectoryChain.from_text_trajectory_chain(c, tokenizer) for c in chains]
    strategy = BlockingStrategy(Padding.RIGHT, Truncation.RIGHT, max_length)

    loop_config = OfflineLoopConfig(
        epochs=args.epochs,
        train_bsize=args.train_bsize,
        log_every=args.log_every,
        eval_every_epochs=None if args.no_eval else args.eval_every_epochs,
        save_dir=save_dir,
        seed=args.seed,
    )
    run = {"bc": run_bc, "filtered_bc": run_bc, "ilql": run_ilql_family, "cql": run_ilql_family, "mc": run_mc,
           "ppo": run_ppo}[args.algo]
    return run(args, task, config, tokenizer, core, token_chains, strategy, loop_config, replay)


def _flatten_chain_windows(token_chains):
    out = []
    for chain in token_chains:
        out.extend(chain.to_list())
    return out


def _bc_dataset(windows, strategy, tokenizer):
    examples = [algo_data.BCExample.from_segments(tt.tokens, tt.is_action) for tt in windows]
    return algo_data.ArrayDataset(algo_data.block_bc_examples(examples, strategy, tokenizer.pad_token_id))


def _online_config(args, loop_config, **kw):
    return OnlineLoopConfig(
        n_rounds=args.online_rounds,
        epochs_per_round=args.epochs,
        train_bsize=args.train_bsize,
        log_every=args.log_every,
        eval_every_rounds=None if args.no_eval else 1,
        save_dir=loop_config.save_dir,
        seed=args.seed,
        **kw,
    )


def _round_seed(args, round_idx: int) -> int:
    return args.seed * 7 + round_idx * 1009


def run_bc(args, task, config, tokenizer, core, token_chains, strategy, loop_config, replay=None):
    from lmrl_gym_torch.algos.bc import BCBatch, BCConfig, BCTrainState, make_bc_train_step

    device = core.device
    windows = _flatten_chain_windows(token_chains)
    if args.algo == "filtered_bc":
        # %BC: keep top-fraction chains by total reward, then their windows
        scored = [(sum(sum(tt.reward) for tt in c.to_list()), c) for c in token_chains]
        keep = algo_data.filter_items(lambda x: x[0], scored, args.filter_top_frac)
        windows = _flatten_chain_windows([c for _, c in keep])
        print(f"%BC filter: kept {len(keep)}/{len(token_chains)} chains")
    if args.data_jsonl:
        # streamed from disk: corpora that never need to be fully resident
        dataset = algo_data.IterableDataset(
            algo_data.bc_rows_from_segments_jsonl(args.data_jsonl, tokenizer, strategy)
        )
        print(f"streaming BC data from {args.data_jsonl}")
    else:
        dataset = _bc_dataset(windows, strategy, tokenizer)
    params = _initial(replay, "base", lambda: init_params(config, seed=args.seed, device=device), device)
    state = BCTrainState(model=TrainState(params, make_optimizer(OptimizerConfig(lr=args.lr), params)))
    shard_state(state, core)
    step = _device_steps(make_bc_train_step(core, BCConfig(), tokenizer.pad_token_id, core.mesh), device, args.seed)

    def batch_prep(b):
        t = _tensors(b, device, input_ids=torch.long, training_mask=torch.bool)
        return BCBatch(t["input_ids"], t["training_mask"])

    evaluator = None
    if not args.no_eval:
        evaluator = make_policy_evaluator(args, task, tokenizer, core, lambda s: s.model.params)
    modules = lambda s: {"base": s.model}  # noqa: E731
    configs = {"base": config.to_dict()}

    if args.online_rounds > 0:
        # online (filtered) BC: rollout → filter → BC epochs per round; a
        # None dataset skips the round when the filter keeps nothing
        server = LMServer(core, tokenizer)
        sampling = make_rollout_sampling(args, tokenizer)
        max_len = args.max_length or task.max_length

        def load_dataset(train_state, round_idx):
            generate = make_generate(server, lambda: train_state.model.params, max_len, sampling, replay)
            chains, summary = collect_rollout_chains(args, task, tokenizer, generate, _round_seed(args, round_idx),
                                                     device)
            print(f"round {round_idx}: rollout reward {summary['reward']['mean']:.3f}")
            if args.algo == "filtered_bc":
                scored = [(sum(c.text_trajectory.reward), c) for c in chains]
                chains = [c for _, c in algo_data.filter_items(lambda x: x[0], scored, args.filter_top_frac)]
                if not chains:
                    return None
            token_chains_r = [TokenTrajectoryChain.from_text_trajectory_chain(c, tokenizer) for c in chains]
            return _bc_dataset(_flatten_chain_windows(token_chains_r), strategy, tokenizer)

        state, loop_state = online_train_loop(
            state, step, load_dataset, _online_config(args, loop_config), batch_prep=batch_prep,
            evaluator=evaluator, module_getter=modules, module_configs=configs,
        )
    else:
        state, loop_state = offline_train_loop(
            state, step, dataset, loop_config, batch_prep=batch_prep, evaluator=evaluator,
            module_getter=modules, module_configs=configs,
        )
    print(f"done: {loop_state.step} steps, best_perf={loop_state.best_perf}")
    return state, loop_state


def _ilql_dataset(token_chains, strategy, tokenizer):
    examples = []
    for chain in token_chains:
        curr = chain
        while curr is not None:
            examples.append(algo_data.ILQLExample.from_chain(curr))
            curr = curr.next
    return algo_data.ArrayDataset(algo_data.block_ilql_examples(examples, strategy, tokenizer.pad_token_id))


def run_ilql_family(args, task, config, tokenizer, core, token_chains, strategy, loop_config, replay=None):
    from lmrl_gym_torch.algos.cql import CQLConfig, init_cql_state, make_cql_train_step
    from lmrl_gym_torch.algos.ilql import ILQLBatch, ILQLConfig, init_ilql_state, make_ilql_train_step

    device = core.device
    dataset = _ilql_dataset(token_chains, strategy, tokenizer)
    s = args.seed
    base = _initial(replay, "base", lambda: init_params(config, seed=s, device=device), device)
    q1 = _initial(replay, "q1_head", lambda: build_head("mlp", config, device, s + 1)[0], device)
    q2 = _initial(replay, "q2_head", lambda: build_head("mlp", config, device, s + 2)[0], device)
    base_tx = make_optimizer(OptimizerConfig(lr=args.lr), base)
    head_tx = make_optimizer(OptimizerConfig(lr=args.head_lr), q1)
    ilql = args.algo == "ilql"

    if ilql:
        v = _initial(replay, "v_head", lambda: build_head("mlp", config, device, s + 3, output_dim=1)[0], device)
        algo_config = ILQLConfig(gamma=args.gamma, tau=args.tau, cql_weight=args.cql_weight, beta=args.beta,
                                 polyak_alpha=args.polyak_alpha)
        state = init_ilql_state(base, q1, q2, v, base_tx, head_tx, algo_config)
        step = make_ilql_train_step(core, algo_config, tokenizer.pad_token_id, core.mesh)
    else:
        algo_config = CQLConfig(gamma=args.gamma, cql_weight=args.cql_weight, beta=args.beta,
                                polyak_alpha=args.polyak_alpha)
        state = init_cql_state(base, q1, q2, base_tx, head_tx, algo_config)
        step = make_cql_train_step(core, algo_config, tokenizer.pad_token_id, core.mesh)
    shard_state(state, core)
    step = _device_steps(step, device, args.seed)

    def modules(st):
        out = {"base": st.base, "target_base": st.target_base_params, "q1_head": st.q1_head,
               "q2_head": st.q2_head}
        if ilql:
            out["v_head"] = st.v_head
        out.update(q1_target_head=st.q1_target_params, q2_target_head=st.q2_target_params)
        return out

    def batch_prep(b):
        t = _tensors(b, device, input_ids=torch.long, should_take_action=torch.bool, rewards=torch.float32,
                     dones=torch.bool, next_token_ids=torch.long, next_dones=torch.bool)
        return ILQLBatch(t["input_ids"], t["should_take_action"], t["rewards"], t["dones"], t["next_token_ids"],
                         t["next_dones"])

    server = ValueGuidedServer(core, tokenizer, beta=args.beta, share_trunk=True)
    max_len = args.max_length or task.max_length

    def bundle(train_state):
        return ValueRLParams(
            pi_beta=None,
            base=train_state.base.params,
            q1_head=train_state.q1_head.params,
            q2_head=train_state.q2_head.params,
            v_head=train_state.v_head.params if ilql else None,
        )

    evaluator = None
    if not args.no_eval:
        sampling = _greedy_sampling(args, tokenizer)

        def evaluator(train_state):
            generate = make_generate(server, lambda: bundle(train_state), max_len, sampling, None)
            return _eval_rollouts(args, task, generate, args.seed + 999, device)

    configs = {"base": config.to_dict()}
    if args.online_rounds > 0:
        # online ILQL/CQL: value-guided rollouts feed fresh Q-learning
        # batches each round
        sampling_r = make_rollout_sampling(args, tokenizer)

        def load_dataset(train_state, round_idx):
            generate = make_generate(server, lambda: bundle(train_state), max_len, sampling_r, replay)
            chains, summary = collect_rollout_chains(args, task, tokenizer, generate, _round_seed(args, round_idx),
                                                     device)
            print(f"round {round_idx}: rollout reward {summary['reward']['mean']:.3f}")
            token_chains_r = [TokenTrajectoryChain.from_text_trajectory_chain(c, tokenizer) for c in chains]
            return _ilql_dataset(token_chains_r, strategy, tokenizer)

        state, loop_state = online_train_loop(
            state, step, load_dataset, _online_config(args, loop_config), batch_prep=batch_prep,
            evaluator=evaluator, module_getter=modules, module_configs=configs,
        )
    else:
        state, loop_state = offline_train_loop(
            state, step, dataset, loop_config, batch_prep=batch_prep, evaluator=evaluator,
            module_getter=modules, module_configs=configs,
        )
    print(f"done: {loop_state.step} steps, best_perf={loop_state.best_perf}")
    return state, loop_state


def run_mc(args, task, config, tokenizer, core, token_chains, strategy, loop_config, replay=None):
    from lmrl_gym_torch.algos.mc import MCBatch, MCConfig, MCTrainState, make_mc_train_step

    device = core.device
    examples = []
    for chain in token_chains:
        curr = chain
        while curr is not None:
            examples.append(algo_data.MCExample.from_chain(curr, gamma=args.gamma))
            curr = curr.next
    dataset = algo_data.ArrayDataset(algo_data.block_mc_examples(examples, strategy, tokenizer.pad_token_id))
    base = _initial(replay, "base", lambda: init_params(config, seed=args.seed, device=device), device)
    q = _initial(replay, "q_head", lambda: build_head("mlp", config, device, args.seed + 1)[0], device)
    state = MCTrainState(
        base=TrainState(base, make_optimizer(OptimizerConfig(lr=args.lr), base)),
        q_head=TrainState(q, make_optimizer(OptimizerConfig(lr=args.head_lr), q)),
    )
    shard_state(state, core)
    algo_config = MCConfig(gamma=args.gamma, cql_weight=args.cql_weight, beta=args.beta)
    step = _device_steps(make_mc_train_step(core, algo_config, tokenizer.pad_token_id, core.mesh), device,
                         args.seed)

    def batch_prep(b):
        t = _tensors(b, device, input_ids=torch.long, should_take_action=torch.bool, returns=torch.float32)
        return MCBatch(t["input_ids"], t["should_take_action"], t["returns"])

    state, loop_state = offline_train_loop(
        state, step, dataset, loop_config, batch_prep=batch_prep,
        module_getter=lambda s: {"base": s.base, "q_head": s.q_head},
        module_configs={"base": config.to_dict()},
    )
    print(f"done: {loop_state.step} steps")
    return state, loop_state


def run_ppo(args, task, config, tokenizer, core, token_chains, strategy, loop_config, replay=None):
    """PPO through the round-based online loop: per round — rollouts
    (online) or the fixed offline chains → one refresh of logprobs /
    values / GAE → KL-controller update from the measured KL → train
    epochs (optionally with a mixed-in BC loss) → eval → checkpoint
    policy / value_head / loop_state."""
    from lmrl_gym_torch.algos.ppo import (
        AdaptiveKLController,
        FixedKLController,
        PPOBatch,
        PPOConfig,
        PPOTrainState,
        block_ppo_data,
        get_ppo_data_from_chains,
        make_ppo_forward_fn,
        make_ppo_train_step,
    )
    from lmrl_gym_torch.loops.checkpoints import LoopState, restore_module

    device = core.device
    policy = _initial(replay, "policy", lambda: init_params(config, seed=args.seed, device=device), device)
    value_head, vh_cfg = build_head("linear", config, device, args.seed + 1, output_dim=1,
                                    bias_init=args.ppo_value_bias_init)
    if replay is not None and "value_head" in replay.modules:
        value_head = replay.modules["value_head"].to(device)
    loop_state = None
    if args.resume:
        restore_module(args.resume, "policy", policy)
        restore_module(args.resume, "value_head", value_head)
        lp = os.path.join(args.resume, "loop_state.pkl")
        if os.path.exists(lp):
            loop_state = LoopState.load(lp)
        print(f"resumed PPO from {args.resume} (round {loop_state.round if loop_state else 0})")
    # π₀ KL anchor: one frozen copy of the (possibly resumed) initial policy
    init_policy = copy.deepcopy(policy).requires_grad_(False)
    state = PPOTrainState(
        policy=TrainState(policy, make_optimizer(OptimizerConfig(lr=args.lr), policy)),
        value_head=TrainState(value_head, make_optimizer(OptimizerConfig(lr=args.head_lr), value_head)),
    )
    shard_state(state, core)
    if core.mesh is not None:
        shard_module(init_policy, core.mesh)
    algo_config = PPOConfig(gamma=args.gamma, lam=args.ppo_lam, bc_loss_weight=args.bc_loss_weight)
    step = _device_steps(make_ppo_train_step(core, algo_config, tokenizer.pad_token_id, core.mesh), device,
                         args.seed)
    max_length = args.max_length or task.max_length
    server = LMServer(core, tokenizer)
    sampling = make_rollout_sampling(args, tokenizer)
    kl_controller = (
        AdaptiveKLController(args.ppo_kl_weight, args.ppo_kl_target, args.ppo_kl_horizon)
        if args.ppo_kl_target is not None
        else FixedKLController(args.ppo_kl_weight)
    )

    # the optional BC mixin stream from the behavior data
    bc_blocked = None
    if args.bc_loss_weight > 0.0:
        bc_examples = [algo_data.BCExample.from_segments(tt.tokens, tt.is_action)
                       for tt in _flatten_chain_windows(token_chains)]
        bc_blocked = algo_data.block_bc_examples(bc_examples, strategy, tokenizer.pad_token_id)

    def load_dataset(train_state, round_idx):
        if args.online_rounds == 0:
            chains_r = token_chains
        else:
            generate = make_generate(server, lambda: train_state.policy.params, max_length, sampling, replay)
            chains, summary = collect_rollout_chains(args, task, tokenizer, generate, _round_seed(args, round_idx),
                                                     device)
            print(f"round {round_idx}: rollout reward {summary['reward']['mean']:.3f}")
            chains_r = [TokenTrajectoryChain.from_text_trajectory_chain(c, tokenizer) for c in chains]

        forward_fn = make_ppo_forward_fn(core, init_policy, train_state.policy.params, train_state.value_head.params,
                                         tokenizer.pad_token_id)
        datas, kls = get_ppo_data_from_chains(
            forward_fn, tokenizer, chains_r, bsize=args.train_bsize, max_length=max_length,
            gamma=args.gamma, lam=args.ppo_lam, kl_weight=kl_controller.value,
        )
        mean_kl = float(np.mean(kls)) if len(kls) else 0.0
        kl_controller.update(mean_kl, len(datas))
        print(f"round {round_idx}: mean_kl={mean_kl:.4f} kl_coef={kl_controller.value:.5f} ({len(datas)} windows)")
        blocked = block_ppo_data(datas, BlockingStrategy(Padding.RIGHT, Truncation.RIGHT, max_length),
                                 tokenizer.pad_token_id)
        if bc_blocked is not None:
            # cycle BC rows to the PPO row count so batches slice together
            idx = np.arange(len(blocked["input_ids"])) % len(bc_blocked["input_ids"])
            blocked["bc_input_ids"] = bc_blocked["input_ids"][idx]
            blocked["bc_training_mask"] = bc_blocked["training_mask"][idx]
        return algo_data.ArrayDataset(blocked)

    def batch_prep(b):
        t = _tensors(b, device, input_ids=torch.long, should_take_action=torch.bool, old_logprobs=torch.float32,
                     old_values=torch.float32, old_advantages=torch.float32, old_returns=torch.float32,
                     bc_input_ids=torch.long, bc_training_mask=torch.bool)
        return PPOBatch(t["input_ids"], t["should_take_action"], t["old_logprobs"], t["old_values"],
                        t["old_advantages"], t["old_returns"], t["bc_input_ids"], t["bc_training_mask"])

    evaluator = None
    if not args.no_eval:
        evaluator = make_policy_evaluator(args, task, tokenizer, core, lambda s: s.policy.params)

    # the JAX head config has no matmul_precision; the CLI keeps its float32
    vh_config = {k: v for k, v in vh_cfg.to_dict().items() if k != "matmul_precision"}
    online_config = OnlineLoopConfig(
        n_rounds=max(1, args.online_rounds),
        epochs_per_round=args.epochs,
        train_bsize=args.train_bsize,
        log_every=args.log_every,
        eval_every_rounds=None if args.no_eval else 1,
        save_every_rounds=1 if loop_config.save_dir else None,
        save_dir=loop_config.save_dir,
        seed=args.seed,
    )
    state, out_loop_state = online_train_loop(
        state, step, load_dataset, online_config, batch_prep=batch_prep, evaluator=evaluator,
        module_getter=lambda s: {"policy": s.policy, "value_head": s.value_head},
        module_configs={"policy": config.to_dict(), "value_head": {"kind": "linear", **vh_config}},
        loop_state=loop_state,
    )
    print(f"done: {out_loop_state.step} steps, best_perf={out_loop_state.best_perf}, "
          f"kl_coef={kl_controller.value:.5f}")
    return state, out_loop_state


if __name__ == "__main__":
    main()
