"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import functools
from typing import Union

import torch
import torch.distributed as dist

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The port runs on the card unless the caller asks for the CPU.

    `None` means `cuda`. Asking for CUDA where there is none raises: the
    port never carries on quietly on the CPU. On CUDA, float32 matrix
    products are pinned to full float32 (no TF32), so the port's f32
    results are comparable with the reference's."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "lmrl_gym_torch: no CUDA device; pass device='cpu' to run "
                "the plain PyTorch path on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string ('bfloat16', 'float32', ...) → torch dtype."""
    return getattr(torch, name)


def inference(fn):
    """Run `fn` under `torch.inference_mode()`, or under `torch.no_grad()`
    while a process group is up: FSDP2 reuses a sharded module's gathered
    parameters from call to call (`parallel/mesh.py`), which inference
    tensors may not be."""

    @functools.wraps(fn)
    def wrapped(*args, **kw):
        with torch.no_grad() if dist.is_initialized() else torch.inference_mode():
            return fn(*args, **kw)

    return wrapped
