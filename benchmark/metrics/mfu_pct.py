"""Model FLOPs of the work completed in the window (benchmark/flops.py,
from the configuration and the traffic's shapes) over the window's seconds
and the H100's bf16 dense peak, in percent."""
from benchmark.flops import PEAK_BF16


def read(run):
    w = run.window
    if "flops_per_unit" not in w:
        return None
    return 100.0 * w["units"] * w["flops_per_unit"] / w["window_s"] / PEAK_BF16
