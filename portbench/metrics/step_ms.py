"""step_ms (end to end, host clock): the window's wall time over the train
steps completed in it (each step's loss read on the host)."""


def read(out):
    w = out.window
    return 1e3 * w.wall_s / w.count if w.unit == "step" and w.count else None
