"""Loss log statistics: the port's copy of `get_tensor_stats` from
`lmrl_gym_tpu/core/logs.py`, and `detach_logs` for the nested dicts the
train steps return. The rest of that module (log pytree merging, flushing)
is not needed yet."""
from __future__ import annotations

from typing import Any, Dict, Union

import torch


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
