"""Device ms a traced ILQL update spends in the optimizer's foreach kernels
(AdamW and the Polyak target updates)."""
from benchmark.trace import category_seconds


def read(run):
    if run.trace is None or "tokens_per_unit" not in run.window:
        return None
    s = category_seconds(run.trace, "optimizer")
    return 1e3 * s / run.trace["units"] if s > 0 else None
