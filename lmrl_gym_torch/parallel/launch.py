"""Run a function on several ranks of a fresh process group, one process
each: the multi-rank harness of the port's dry runs and CPU tests.

`run_ranks(fn, world, args, device="cpu")` spawns `world` processes. Each
starts the group through `core/io.py::distributed_init` (gloo on the CPU,
NCCL on `cuda`, one card per rank) with a file rendezvous in a fresh temp
directory (no port to collide with a concurrent run), calls `fn(*args)`,
and sends back its result. `fn` must be importable by module name (a
function of the package: a `spawn` child imports it afresh). Every group
and the join have a timeout, so a lost or hung rank raises here instead of
hanging the caller; all children are stopped on the way out.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.multiprocessing as mp


def _rank_main(rank: int, world: int, rendezvous: str, out_dir: str, device: str, timeout_s: float,
               fn: Callable, args: Sequence[Any]) -> None:
    import torch.distributed as dist

    from lmrl_gym_torch.core.io import distributed_init

    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        distributed_init(rendezvous, world, rank, device=device, timeout_s=timeout_s)
        result = ("ok", fn(*args))
        dist.barrier()
        dist.destroy_process_group()
    except Exception:  # reported to the parent, which raises
        result = ("error", traceback.format_exc())
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path)
    with open(os.path.join(out_dir, f"rank{rank}.status"), "w") as f:
        f.write(result[0])


def run_ranks(fn: Callable, world: int, args: Sequence[Any] = (), device: str = "cpu",
              timeout_s: float = 240.0) -> List[Any]:
    """[fn(*args) on rank r for r in range(world)], each in its own process
    of one group. Raises on any rank's error or after `timeout_s`."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="lmrl_ranks_") as out_dir:
        rendezvous = "file://" + os.path.join(out_dir, "store")
        procs = [ctx.Process(target=_rank_main, args=(r, world, rendezvous, out_dir, device, timeout_s, fn,
                                                      tuple(args)), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                failed = [r for r in range(world) if _status(out_dir, r) == "error"]
                if failed:  # the others would wait on it until the group's timeout
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks of {getattr(fn, '__name__', fn)} did not finish in "
                                       f"{timeout_s} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        results = [_result(out_dir, r) for r in range(world)]
        for r, res in enumerate(results):
            if res is not None and res[0] == "error":
                raise RuntimeError(f"rank {r} failed:\n{res[1]}")
        for r, res in enumerate(results):
            if res is None:
                raise RuntimeError(f"rank {r} exited with code {procs[r].exitcode} and no result")
        return [value for _, value in results]


def _result(out_dir: str, rank: int):
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)


def _status(out_dir: str, rank: int):
    path = os.path.join(out_dir, f"rank{rank}.status")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read()
