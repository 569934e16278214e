"""The least time K2 + K3 could take for the traced updates' backward
attention (benchmark/flops.py: max(bytes / HBM bandwidth, FLOPs / bf16
peak) per kernel) over their device time, in percent."""
from benchmark.trace import category_seconds


def read(run):
    if run.trace is None or "bwd_least_s_per_unit" not in run.window:
        return None
    s = category_seconds(run.trace, "K2") + category_seconds(run.trace, "K3")
    if s <= 0:
        return None
    return 100.0 * run.trace["units"] * run.window["bwd_least_s_per_unit"] / s
