"""Bucket-transparent file IO, jsonl helpers and the process-group
bootstrap: the port of `lmrl_gym_tpu/core/io.py`, with `distributed_init`
and `is_main_process` on `torch.distributed`.

`gcs://` / `gs://` paths route through `gcsfs` when it is installed, a
lazy import that raises on such a path when it is absent; everything else
is plain local IO.
"""
from __future__ import annotations

import datetime
import json
import os
import shutil
from typing import Any, Iterator, List, Optional

import torch
import torch.distributed as dist

from lmrl_gym_torch.core.device import DeviceLike, resolve_device

_GCS_PREFIXES = ("gcs://", "gs://")


def is_bucket_path(path: str) -> bool:
    return path.startswith(_GCS_PREFIXES)


def _gcs_fs():
    try:
        import gcsfs
    except ImportError as e:
        raise ImportError("gcs:// paths need the optional gcsfs dependency") from e
    return gcsfs.GCSFileSystem()


def _strip_scheme(path: str) -> str:
    for p in _GCS_PREFIXES:
        if path.startswith(p):
            return path[len(p):]
    return path


def open_with_bucket(path: str, mode: str = "r", **kw):
    """Open a local or gcs:// path with identical semantics; writing to a
    local path creates its parent directory."""
    if is_bucket_path(path):
        return _gcs_fs().open(_strip_scheme(path), mode, **kw)
    if any(m in mode for m in ("w", "a", "x")):
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
    return open(path, mode, **kw)


def delete_with_bucket(path: str, recursive: bool = False) -> None:
    if is_bucket_path(path):
        _gcs_fs().rm(_strip_scheme(path), recursive=recursive)
        return
    if os.path.isdir(path):
        if recursive:
            shutil.rmtree(path)
        else:
            os.rmdir(path)
    elif os.path.exists(path):
        os.remove(path)


def exists_with_bucket(path: str) -> bool:
    if is_bucket_path(path):
        return _gcs_fs().exists(_strip_scheme(path))
    return os.path.exists(path)


def makedirs_with_bucket(path: str) -> str:
    """mkdir -p for local paths; a no-op for buckets (GCS has no dirs)."""
    if not is_bucket_path(path):
        os.makedirs(path, exist_ok=True)
    return path


def jsonl_stream(path: str) -> Iterator[Any]:
    """Lazily yield one parsed object per non-blank line."""
    with open_with_bucket(path, "r") as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def jsonl_load(path: str) -> List[Any]:
    return list(jsonl_stream(path))


def jsonl_dump(items, path: str) -> None:
    with open_with_bucket(path, "w") as f:
        for item in items:
            f.write(json.dumps(item) + "\n")


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = None,
    timeout_s: float = 300.0,
) -> bool:
    """Start the process group a multi-rank run needs; True when one is up.

    A no-op (False) unless explicit arguments or the launcher's environment
    (`WORLD_SIZE` > 1, as `torchrun` sets it) ask for a group, as the JAX
    package's bootstrap is for a single host. The backend follows the
    device: NCCL for `cuda` (each rank on card `LOCAL_RANK`, else its
    rank modulo the card count), gloo for `cpu`; a `cuda` request on a
    host without CUDA raises. `coordinator_address` is `host:port` (TCP
    rendezvous; the launcher's `MASTER_ADDR`/`MASTER_PORT` otherwise).
    Every collective of the group fails after `timeout_s`, so a lost rank
    ends the run instead of hanging it."""
    if dist.is_initialized():
        return True
    if num_processes is None and coordinator_address is None:
        env_n = os.environ.get("WORLD_SIZE")
        if env_n is None or int(env_n) <= 1:
            return False  # one process: nothing to start
    dev = resolve_device(device)
    world = num_processes if num_processes is not None else int(os.environ["WORLD_SIZE"])
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:  # a URL (file:// rendezvous)
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    global _TIMEOUT
    _TIMEOUT = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=init_method,
        world_size=world,
        rank=rank,
        timeout=_TIMEOUT,
        device_id=torch.device("cuda", torch.cuda.current_device()) if dev.type == "cuda" else None,
    )
    return True


# the group's timeout, for its subgroups: process-wide, as the group is
_TIMEOUT = datetime.timedelta(seconds=300)


def group_timeout() -> datetime.timedelta:
    """The timeout `distributed_init` gave the group, for its subgroups."""
    return _TIMEOUT


def is_main_process() -> bool:
    """Rank 0 of the group, or the only process when none was started."""
    return not dist.is_initialized() or dist.get_rank() == 0
