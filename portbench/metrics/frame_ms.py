"""frame_ms (end to end, host clock): the window's wall time over the
frames completed in it."""


def read(out):
    w = out.window
    return 1e3 * w.wall_s / w.count if w.unit == "frame" and w.count else None
