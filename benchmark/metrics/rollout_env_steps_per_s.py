"""Env-steps of every whole rollout completed in the window (B x 6 each)
over the window's seconds, the window closed by a synchronise."""


def read(run):
    w = run.window
    if "env_steps_per_unit" not in w:
        return None
    return w["units"] * w["env_steps_per_unit"] / w["window_s"]
