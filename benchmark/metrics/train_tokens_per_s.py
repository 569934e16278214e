"""Tokens of every ILQL update completed in the window (B x T each) over the
window's seconds, the window closed by a synchronise."""


def read(run):
    w = run.window
    if "tokens_per_unit" not in w:
        return None
    return w["units"] * w["tokens_per_unit"] / w["window_s"]
