"""The least time K4 could take for the traced rollouts' single-token steps
(benchmark/flops.py: bytes of the cache slots each step reads, or its
FLOPs at the bf16 peak) over K4's device time, in percent."""
from benchmark.trace import category_seconds


def read(run):
    if run.trace is None or "decode_least_s_per_unit" not in run.window:
        return None
    s = category_seconds(run.trace, "K4")
    if s <= 0:
        return None
    return 100.0 * run.trace["units"] * run.window["decode_least_s_per_unit"] / s
