"""The 95th percentile (nearest rank) of one ILQL update's time in the
window, from CUDA events recorded as each update is enqueued and read after
the window's synchronise."""
import math


def read(run):
    w = run.window
    if "tokens_per_unit" not in w or not w["unit_s"]:
        return None
    s = sorted(w["unit_s"])
    return 1e3 * s[math.ceil(0.95 * len(s)) - 1]
