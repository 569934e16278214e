"""Bucket-transparent file IO and jsonl helpers: the port's copy of
`lmrl_gym_tpu/core/io.py` less `distributed_init` and `is_main_process`
(they come with the parallelism work, on `torch.distributed`).

`gcs://` / `gs://` paths route through `gcsfs` when it is installed, a
lazy import that raises on such a path when it is absent; everything else
is plain local IO.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Iterator, List

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
