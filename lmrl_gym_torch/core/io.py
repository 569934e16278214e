"""jsonl helpers: the port's copy of `jsonl_stream`, `jsonl_load` and
`jsonl_dump` from `lmrl_gym_tpu/core/io.py`, for local paths. Bucket I/O
and the multi-process bootstrap are not ported yet."""
from __future__ import annotations

import json
from typing import Any, Iterator, List


def jsonl_stream(path: str) -> Iterator[Any]:
    """Lazily yield one parsed object per non-blank line."""
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def jsonl_load(path: str) -> List[Any]:
    return list(jsonl_stream(path))


def jsonl_dump(items, path: str) -> None:
    with open(path, "w") as f:
        for item in items:
            f.write(json.dumps(item) + "\n")
