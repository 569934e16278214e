"""Offline training loop: epochs over a fixed dataset with periodic
eval / save / resume. The port of `lmrl_gym_tpu/loops/offline.py`.

Per epoch, shuffled batches → step_fn; periodic eval (with best-checkpoint
tracking), a rolling checkpoint queue, and resume that restarts at
`loop_state.epoch` with the batch order's numpy stream seeded afresh from
`config.seed`, as the JAX loop does.

`step_fn(train_state, batch, generator)` gets the loop's CPU
`torch.Generator` (seeded from `config.seed`, advancing from step to
step) where the JAX loop hands each step a split PRNG key.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from lmrl_gym_torch.algos.data import ArrayDataset
from lmrl_gym_torch.core.logs import combine_logs, label_logs, log, pull_logs
from lmrl_gym_torch.loops.checkpoints import CheckpointManager, LoopState

# step_fn(train_state, batch, generator) -> (train_state, loss, logs)
StepFn = Callable[[Any, Any, torch.Generator], Tuple[Any, Any, Any]]
# evaluator(train_state) -> (perf_metric, logs) — higher perf is better
Evaluator = Callable[[Any], Tuple[float, Any]]


@dataclass
class OfflineLoopConfig:
    epochs: int = 1
    train_bsize: int = 32
    log_every: Optional[int] = 256
    eval_every_steps: Optional[int] = None
    eval_every_epochs: Optional[int] = 1
    save_every_steps: Optional[int] = None
    save_every_epochs: Optional[int] = None
    save_at_end: bool = True
    save_best: bool = True
    max_checkpoints: Optional[int] = 3
    save_dir: Optional[str] = None
    save_train_state: bool = False
    use_wandb: bool = False
    seed: int = 0


def offline_train_loop(
    train_state: Any,
    step_fn: StepFn,
    dataset: ArrayDataset,
    config: OfflineLoopConfig,
    batch_prep: Optional[Callable[[Dict[str, np.ndarray]], Any]] = None,
    evaluator: Optional[Evaluator] = None,
    module_getter: Optional[Callable[[Any], Dict[str, Any]]] = None,
    module_configs: Optional[Dict[str, dict]] = None,
    loop_state: Optional[LoopState] = None,
) -> Tuple[Any, LoopState]:
    """Returns (final train_state, loop_state). `batch_prep` converts the
    dict batch into the algorithm's batch type; `module_getter` maps the
    train state to the named-module dict for checkpointing."""
    generator = torch.Generator().manual_seed(config.seed)
    data_rng = np.random.default_rng(config.seed)
    loop_state = loop_state or LoopState()
    manager = CheckpointManager(config.save_dir, config.max_checkpoints)
    step_logs = []

    def modules():
        assert module_getter is not None, "module_getter required for saving"
        return module_getter(train_state)

    def maybe_eval():
        if evaluator is None:
            return
        perf, eval_logs = evaluator(train_state)
        log(label_logs(pull_logs(eval_logs), "eval", {"step": loop_state.step, "epoch": loop_state.epoch}),
            use_wandb=config.use_wandb)
        if config.save_best and perf > loop_state.best_perf and config.save_dir:
            loop_state.best_perf = perf
            manager.save("best", loop_state, modules(), module_configs, save_train_state=False, rolling=False)

    def maybe_save(tag: str):
        if config.save_dir:
            manager.save(tag, loop_state, modules(), module_configs, save_train_state=config.save_train_state)

    start_epoch = loop_state.epoch
    for epoch in range(start_epoch, config.epochs):
        loop_state.epoch = epoch
        for batch in dataset.batches(config.train_bsize, rng=data_rng):
            prepared = batch_prep(batch) if batch_prep else batch
            train_state, loss, logs = step_fn(train_state, prepared, generator)
            step_logs.append(logs)
            loop_state.step += 1

            if config.log_every and loop_state.step % config.log_every == 0:
                log(label_logs(pull_logs(combine_logs(step_logs)), "train", {"step": loop_state.step, "epoch": epoch}),
                    use_wandb=config.use_wandb)
                step_logs = []
            if config.eval_every_steps and loop_state.step % config.eval_every_steps == 0:
                maybe_eval()
            if config.save_every_steps and loop_state.step % config.save_every_steps == 0:
                maybe_save(f"step_{loop_state.step}")

        if config.eval_every_epochs and (epoch + 1) % config.eval_every_epochs == 0:
            maybe_eval()
        if config.save_every_epochs and (epoch + 1) % config.save_every_epochs == 0:
            maybe_save(f"epoch_{epoch}")

    loop_state.epoch = config.epochs
    if config.save_at_end and config.save_dir:
        maybe_save("last")
    return train_state, loop_state
