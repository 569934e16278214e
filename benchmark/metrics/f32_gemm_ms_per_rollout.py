"""Device ms a traced rollout spends in float32 GEMMs (the Q heads
and, for GPT-J, lm_head), by kernel name (benchmark/trace.py)."""
from benchmark.trace import category_seconds


def read(run):
    if run.trace is None or "env_steps_per_unit" not in run.window:
        return None
    s = category_seconds(run.trace, "gemm f32")
    return 1e3 * s / run.trace["units"] if s > 0 else None
