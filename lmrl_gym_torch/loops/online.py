"""Round-based online loop: rollout → dataset → train → refresh policy.
The port of `lmrl_gym_tpu/loops/online.py`.

Per round r: `dataset = load_dataset(train_state, r)` (fresh rollouts from
the live state; None skips the round, the filtered-BC empty-filter case),
then epochs of batches through step_fn; periodic eval / save. Resume
restarts at `loop_state.round`.

`step_fn(train_state, batch, generator)` gets the loop's CPU
`torch.Generator` (seeded from `config.seed`) where the JAX loop hands
each step a split PRNG key.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from lmrl_gym_torch.algos.data import ArrayDataset
from lmrl_gym_torch.core.logs import combine_logs, label_logs, log, pull_logs
from lmrl_gym_torch.loops.checkpoints import CheckpointManager, LoopState

# load_dataset(train_state, round) -> ArrayDataset | None
DatasetLoader = Callable[[Any, int], Optional[ArrayDataset]]
StepFn = Callable[[Any, Any, torch.Generator], Tuple[Any, Any, Any]]
Evaluator = Callable[[Any], Tuple[float, Any]]


@dataclass
class OnlineLoopConfig:
    n_rounds: int = 10
    epochs_per_round: int = 1
    train_bsize: int = 32
    log_every: Optional[int] = 64
    eval_every_rounds: Optional[int] = 1
    save_every_rounds: Optional[int] = None
    save_at_end: bool = True
    save_best: bool = True
    max_checkpoints: Optional[int] = 2
    save_dir: Optional[str] = None
    save_train_state: bool = False
    use_wandb: bool = False
    seed: int = 0


def online_train_loop(
    train_state: Any,
    step_fn: StepFn,
    load_dataset: DatasetLoader,
    config: OnlineLoopConfig,
    batch_prep: Optional[Callable[[Dict[str, np.ndarray]], Any]] = None,
    evaluator: Optional[Evaluator] = None,
    module_getter: Optional[Callable[[Any], Dict[str, Any]]] = None,
    module_configs: Optional[Dict[str, dict]] = None,
    loop_state: Optional[LoopState] = None,
) -> Tuple[Any, LoopState]:
    generator = torch.Generator().manual_seed(config.seed)
    data_rng = np.random.default_rng(config.seed)
    loop_state = loop_state or LoopState()
    manager = CheckpointManager(config.save_dir, config.max_checkpoints)

    def modules():
        assert module_getter is not None
        return module_getter(train_state)

    def maybe_eval():
        if evaluator is None:
            return
        perf, eval_logs = evaluator(train_state)
        log(label_logs(pull_logs(eval_logs), "eval", {"round": loop_state.round, "step": loop_state.step}),
            use_wandb=config.use_wandb)
        if config.save_best and perf > loop_state.best_perf and config.save_dir:
            loop_state.best_perf = perf
            manager.save("best", loop_state, modules(), module_configs, rolling=False)

    start_round = loop_state.round
    for round_idx in range(start_round, config.n_rounds):
        loop_state.round = round_idx
        dataset = load_dataset(train_state, round_idx)
        if dataset is None:  # an empty filter result skips the round
            continue

        step_logs = []
        for _epoch in range(config.epochs_per_round):
            for batch in dataset.batches(config.train_bsize, rng=data_rng, drop_last=False):
                prepared = batch_prep(batch) if batch_prep else batch
                train_state, loss, logs = step_fn(train_state, prepared, generator)
                step_logs.append(logs)
                loop_state.step += 1
                if config.log_every and loop_state.step % config.log_every == 0:
                    log(label_logs(pull_logs(combine_logs(step_logs)), "train",
                                   {"round": round_idx, "step": loop_state.step}), use_wandb=config.use_wandb)
                    step_logs = []

        if config.eval_every_rounds and (round_idx + 1) % config.eval_every_rounds == 0:
            maybe_eval()
        if config.save_every_rounds and (round_idx + 1) % config.save_every_rounds == 0 and config.save_dir:
            manager.save(f"round_{round_idx}", loop_state, modules(), module_configs,
                         save_train_state=config.save_train_state)

    loop_state.round = config.n_rounds
    if config.save_at_end and config.save_dir:
        manager.save("last", loop_state, modules(), module_configs, save_train_state=config.save_train_state)
    return train_state, loop_state
