"""Metric log trees: the port of `lmrl_gym_tpu/core/logs.py`.

Every loss emits a nested dict of scalars (0-d tensors) or `LogTuple`s;
lists of such trees are merged by count-weighted mean (`combine_logs`),
reduced to host floats (`pull_logs`), labeled, and printed (and pushed to
wandb when it is installed and a run is open). `detach_logs` cuts a train
step's log tree from the autograd graph.
"""
from __future__ import annotations

from functools import reduce
from typing import Any, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

try:  # wandb is optional; never required
    import wandb  # type: ignore

    _WANDB = True
except Exception:
    _WANDB = False


class LogTuple(NamedTuple):
    mean: Any
    count: Any


def get_tensor_stats(x: torch.Tensor, mask: torch.Tensor, n: Union[int, float, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Masked mean/min/max/std of a tensor, as a dict of 0-d tensors (the
    std over `n`, not over the mask's count)."""
    mask = mask.float()
    while mask.ndim < x.ndim:
        mask = mask[..., None]
    mean = (x * mask).sum() / n
    second = ((x - mean) ** 2 * mask).sum() / n
    return dict(
        mean=mean,
        min=torch.where(mask > 0, x, torch.inf).min(),
        max=torch.where(mask > 0, x, -torch.inf).max(),
        std=torch.sqrt(torch.clamp(second, min=0.0)),
    )


def detach_logs(logs: Any) -> Any:
    """The same nested dict of 0-d tensors, cut from the autograd graph."""
    if isinstance(logs, dict):
        return {k: detach_logs(v) for k, v in logs.items()}
    return logs.detach()


def _map(fn, trees: List[Any], key: str = "") -> Any:
    """fn(key, *leaves) over trees of one structure; `key` is the leaf's
    own dict key (tree_map_with_path's last path entry). Dicts come back
    with their keys sorted, as jax's tree functions rebuild them."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, [t[k] for t in trees], str(k)) for k in sorted(first)}
    if isinstance(first, (list, tuple)) and not isinstance(first, LogTuple):
        return type(first)(_map(fn, [t[i] for t in trees], "") for i in range(len(first)))
    return fn(key, *trees)


def _maximum(a, b):
    return torch.maximum(torch.as_tensor(a), torch.as_tensor(b)) if isinstance(a, torch.Tensor) or isinstance(
        b, torch.Tensor) else max(a, b)


def _minimum(a, b):
    return torch.minimum(torch.as_tensor(a), torch.as_tensor(b)) if isinstance(a, torch.Tensor) or isinstance(
        b, torch.Tensor) else min(a, b)


def combine_logs(logs: List[Any]) -> Any:
    """Merge a list of log trees by count-weighted mean. Scalars count as
    LogTuple(value, 1); `min` / `max` keys reduce by min / max (so
    `get_tensor_stats` output composes)."""
    assert len(logs) > 0

    def combine(key, *leaves):
        tuples = [leaf if isinstance(leaf, LogTuple) else LogTuple(leaf, 1) for leaf in leaves]
        if key == "min":
            return LogTuple(reduce(_minimum, [t.mean for t in tuples]), 1)
        if key == "max":
            return LogTuple(reduce(_maximum, [t.mean for t in tuples]), 1)
        total = sum(t.count for t in tuples)
        mean = sum(t.mean * t.count for t in tuples) / _maximum(total, 1)
        return LogTuple(mean, total)

    return _map(combine, logs)


def pull_logs(logs: Any) -> Any:
    """Reduce LogTuples and tensors to plain host-side Python numbers."""

    def pull(_, leaf):
        if isinstance(leaf, LogTuple):
            leaf = leaf.mean
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        if isinstance(leaf, (np.ndarray, np.generic)):
            leaf = np.asarray(leaf)
            leaf = leaf.item() if leaf.ndim == 0 else leaf.tolist()
        return leaf

    return _map(pull, [logs])


def label_logs(logs: Any, label: str, to_add: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    out = {label: logs}
    if to_add:
        out.update(to_add)
    return out


def log(logs: Any, use_wandb: bool = False) -> Any:
    """Print a log tree and optionally push it to wandb."""
    logs = pull_logs(logs)
    print(logs, flush=True)
    if use_wandb and _WANDB and wandb.run is not None:
        wandb.log(_flatten("", logs))
    return logs


def _flatten(prefix: str, tree: Any) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(f"{prefix}/{k}" if prefix else str(k), v))
    else:
        out[prefix] = tree
    return out
