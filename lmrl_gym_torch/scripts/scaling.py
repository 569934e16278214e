"""Scaling measurement over the ranks of a process group: the counterpart
of `scripts/scaling.py`.

    python -m lmrl_gym_torch.scripts.scaling [--out SCALING.json]      # the card(s)
    python -m lmrl_gym_torch.scripts.scaling --device cpu [--max-devices 2]  # gloo ranks

Rows, each printed as a JSON line with its `backend` (`nccl` on the card,
`gloo` on the CPU), over n = 1, 2, 4, 8 ranks (one process each):

1. on the card only, weak scaling (a fixed per-rank batch): the vector
   Wordle env's rollouts (`bench_env_rollout`) and the ILQL step
   (`weak_scaling_rows`);
2. fixed total work (`fixed_total_work_rows`): one global batch over 1 and
   n ranks, the step time's growth over one rank being the partitioning's
   overhead;
3. a collective census (`collective_census`, `collective_rows`): the
   collectives one sharded ILQL step issues, by kind, and their output
   bytes, per mesh shape (dp, fsdp, mp).

The ILQL setup is the JAX script's (`_make_ilql_setup`, `_make_batch`:
d256 L4 H4 over the byte vocab, bench's heads, optimizers and batch
recipe) on the port's mesh (`parallel/mesh.py`: the rule tables lowered
onto FSDP2, `sharded_step`). A row whose ranks the machine does not have
is written as `{"n_devices": n, "not_run": ...}`; one card runs the n = 1
rows in a one-rank NCCL group, which shows FSDP2's overhead on one card.
Rows on gloo CPU ranks measure the host, never the card. The weak-scaling
rows are left out there (the ranks share the host's cores), as the JAX
script leaves them out on virtual CPU devices.

No counterpart: the JAX script's projection of the census onto a TPU link
(`ICI_GBPS`, `projected_v5e_ici_ms_per_step`), a number for a TPU. The rows
carry the census bytes and no projection.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import threading
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from lmrl_gym_torch.core.device import DeviceLike, resolve_device
from lmrl_gym_torch.core.io import distributed_init
from lmrl_gym_torch.envs.wordle.vector import N_TRIES, WordleVectorEnv, WordleVocab
from lmrl_gym_torch.models.config import TransformerConfig
from lmrl_gym_torch.parallel.launch import run_ranks
from lmrl_gym_torch.parallel.mesh import Mesh, load_mesh
from lmrl_gym_torch.scripts import bench

POINTS = (1, 2, 4, 8)
CENSUS_SHAPES = ((1, 1, 1), (8, 1, 1), (1, 8, 1), (2, 2, 2), (1, 4, 2))
STEP_REPS = 5  # timed steps per row, after one warm-up (scripts/scaling.py's _time_step)
ENV_REPS = 5
# torch.distributed's collectives by the JAX census's kinds. Each takes its
# output first (all_reduce: the tensor it reduces in place). Point-to-point
# hops (ring attention's, over an sp axis no census shape has) are not counted.
COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_single": "all-gather",
    "_all_gather_base": "all-gather",
    "reduce_scatter": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_single": "reduce-scatter",
    "_reduce_scatter_base": "reduce-scatter",
    "all_to_all": "all-to-all",
    "all_to_all_single": "all-to-all",
}


def default_config() -> TransformerConfig:
    """scripts/scaling.py:145's trunk: d256 L4 H4, the byte vocab (259 ids
    padded to 320), 256 positions, no dropout."""
    return TransformerConfig(vocab_size=259, hidden_size=256, num_layers=4, num_heads=4, max_position_embeddings=256,
                             pad_vocab_to_multiple=64, embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)


def _make_ilql_setup(mesh: Mesh, config: Optional[TransformerConfig] = None):
    """(state, step) of bench's ILQL step (pad id 256) on `mesh`: every
    module sharded by its rule table, the step on the rank's rows."""
    return bench.ilql_state(config or default_config(), 256, mesh.device, mesh)


def _make_batch(B: int, T: int, mesh: Mesh):
    """bench's batch recipe, whole on every rank (the step takes its rows)."""
    return bench.ilql_batch(B, T, mesh.device)


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return sum(_bytes(t) for t in x)


def collective_census(run: Callable[[], object]) -> dict:
    """{kind: {"count", "bytes"}} of the collectives `run()` issues through
    torch.distributed, by the JAX census's kinds, with their output bytes
    (FSDP2's gathers and reduce-scatters, its all-reduces over replicas,
    the steps' own gathers of their loss inputs). A collective that calls
    another counts once. Counted from any thread (the backward's hooks
    may run off the main thread)."""
    census: dict = {}
    lock, local = threading.Lock(), threading.local()
    originals = {name: getattr(dist, name) for name in COLLECTIVES if hasattr(dist, name)}

    def counting(name, fn):
        def wrapped(*args, **kw):
            depth = getattr(local, "depth", 0)
            if depth == 0:
                with lock:
                    entry = census.setdefault(COLLECTIVES[name], {"count": 0, "bytes": 0})
                    entry["count"] += 1
                    entry["bytes"] += _bytes(args[0] if args else next(iter(kw.values())))
            local.depth = depth + 1
            try:
                return fn(*args, **kw)
            finally:
                local.depth = depth
        return wrapped

    try:
        for name, fn in originals.items():
            setattr(dist, name, counting(name, fn))
        run()
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)
    return census


# ---- what one rank does; n > 1 runs these on the ranks of a fresh group (run_ranks)

def _step_time_rank(config: TransformerConfig, shape: Sequence[int], B: int, T: int, device: str) -> float:
    """Seconds per ILQL step at global batch B on the mesh `shape`."""
    mesh = load_mesh(shape, device=device)
    state, step = _make_ilql_setup(mesh, config)
    return bench.time_ilql(state, step, _make_batch(B, T, mesh), STEP_REPS)[0]


def _census_rank(config: TransformerConfig, shapes: Sequence[Sequence[int]], B: int, T: int, device: str) -> list:
    """The census of one ILQL step (after a warm-up) per mesh shape."""
    out = []
    for shape in shapes:
        mesh = load_mesh(shape, device=device)
        state, step = _make_ilql_setup(mesh, config)
        batch = _make_batch(B, T, mesh)
        step(state, batch)
        out.append(collective_census(lambda: step(state, batch)))
    return out


def _env_rank(per_device_batch: int, device: str) -> float:
    """Seconds for ENV_REPS rollouts of per_device_batch games (one warm-up)."""
    env = WordleVectorEnv(WordleVocab.from_file(), device=device)
    gen = torch.Generator(device=device).manual_seed(dist.get_rank() if dist.is_initialized() else 0)
    float(env.rollout_episodes(per_device_batch, gen)[1].sum())
    t0 = time.perf_counter()
    for _ in range(ENV_REPS):
        float(env.rollout_episodes(per_device_batch, gen)[1].sum())  # a value fetch: the window ends on the device
    return time.perf_counter() - t0


def _on_ranks(fn, n: int, args, device: str):
    """fn(*args) on rank 0 of n: in this process's one-rank group for n = 1,
    else on the ranks of a fresh group."""
    return fn(*args) if n == 1 else run_ranks(fn, n, args, device=device)[0]


@contextlib.contextmanager
def one_rank_group(device: DeviceLike):
    """A one-rank process group in this process (NCCL on the card, gloo
    on the CPU) unless one is up already; destroyed on the way out if
    started here."""
    if dist.is_initialized():
        if dist.get_world_size() != 1:
            raise ValueError(f"the scaling rows run from one process; this group has {dist.get_world_size()} ranks")
        yield
        return
    with tempfile.TemporaryDirectory(prefix="lmrl_scaling_") as tmp:
        distributed_init("file://" + os.path.join(tmp, "store"), 1, 0, device=device, timeout_s=300)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _not_run(workload: str, n: int, available: int) -> dict:
    return {"workload": workload, "n_devices": n,
            "not_run": "one device" if available == 1 else f"{available} devices"}


def bench_env_rollout(n: int, device: str, per_device_batch: int = 1024) -> float:
    """Env-steps/s of n ranks each rolling out per_device_batch games."""
    dt = _on_ranks(_env_rank, n, (per_device_batch, device), device)
    return n * per_device_batch * N_TRIES * ENV_REPS / dt


def weak_scaling_rows(points, available: int, device: str, config: TransformerConfig, per_device_batch: int = 4,
                      T: int = 64) -> list:
    """A fixed per-rank batch over growing meshes (n, 1, 1)."""
    rows, base = [], None
    for n in points:
        if n > available:
            rows.append(_not_run("ilql_weak_scaling", n, available))
            continue
        dt = _on_ranks(_step_time_rank, n, (config, (n, 1, 1), per_device_batch * n, T, device), device)
        per_dev = per_device_batch / dt
        base = base or per_dev
        rows.append({"workload": "ilql_weak_scaling", "n_devices": n, "per_device_examples_per_s": round(per_dev, 3),
                     "retention_vs_1dev": round(per_dev / base, 3)})
    return rows


def fixed_total_work_rows(points, available: int, device: str, config: TransformerConfig, total_batch: int = 16,
                          T: int = 64) -> list:
    """One global batch over 1 and n ranks: the step's growth is the
    partitioning's overhead (on a shared host, with the host's share)."""
    rows, base_dt = [], None
    for n in points:
        if n > available:
            rows.append(_not_run("ilql_fixed_total_work", n, available))
            continue
        dt = _on_ranks(_step_time_rank, n, (config, (n, 1, 1), total_batch, T, device), device)
        base_dt = base_dt or dt
        rows.append({"workload": "ilql_fixed_total_work", "n_devices": n, "step_ms": round(dt * 1e3, 2),
                     "partitioning_overhead_pct": round(100 * (dt / base_dt - 1), 1)})
    return rows


def collective_rows(mesh_shapes, available: int, device: str, config: TransformerConfig, B: int = 16,
                    T: int = 64) -> list:
    """The census of one ILQL step per mesh shape; the shapes of one rank
    count share a group."""
    rows = []
    by_n: dict = {}
    for shape in mesh_shapes:
        by_n.setdefault(shape[0] * shape[1] * shape[2], []).append(tuple(shape))
    for n, shapes in by_n.items():
        censuses = _on_ranks(_census_rank, n, (config, shapes, B, T, device), device) if n <= available else None
        for i, (dp, fsdp, mp) in enumerate(shapes):
            row = {**_not_run("ilql_collective_census", n, available), "mesh": f"dp{dp} fsdp{fsdp} mp{mp}"}
            if censuses is not None:
                del row["not_run"]
                row.update(census=censuses[i], collective_bytes_per_step=sum(v["bytes"] for v in censuses[i].values()))
            rows.append(row)
    return rows


def main(argv=None) -> list:
    p = argparse.ArgumentParser()
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default): one rank per card; cpu: gloo ranks")
    p.add_argument("--max-devices", type=int, default=8, help="most ranks a row takes")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    available = min(args.max_devices, torch.cuda.device_count() if on_card else args.max_devices)
    backend = "nccl" if on_card else "gloo"
    config = default_config()
    rows = []
    with one_rank_group(device.type):
        if on_card:
            base = None
            for n in POINTS:
                if n > available:
                    rows.append(_not_run("wordle_env_rollout_weak", n, available))
                    continue
                steps = bench_env_rollout(n, device.type)
                base = base or steps
                rows.append({"workload": "wordle_env_rollout_weak", "n_devices": n,
                             "env_steps_per_s": round(steps, 1), "retention_vs_1dev": round(steps / (base * n), 3)})
            rows += weak_scaling_rows(POINTS, available, device.type, config)
        rows += fixed_total_work_rows(POINTS, available, device.type, config)
        rows += collective_rows(CENSUS_SHAPES, available, device.type, config)
    for r in rows:
        print(json.dumps({**r, "backend": backend}), flush=True)
    if args.out:
        meta = {"backend": backend, "n_devices": available,
                "device": torch.cuda.get_device_name(device) if on_card else "cpu"}
        with open(args.out, "w") as f:
            json.dump({"meta": meta, "rows": rows}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
