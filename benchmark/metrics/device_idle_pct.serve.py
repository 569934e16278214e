"""Share of the traced rollouts' window (host clock, closed by a
synchronise) in which no operation ran on the device: 1 - the union of the
device operations' intervals over the window, in percent."""


def read(run):
    if run.trace is None or "env_steps_per_unit" not in run.window or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
