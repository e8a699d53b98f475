"""busy_ms.frame (tile and frame layer, profiler): the union of the
device's kernel and copy intervals a traced frame."""


def read(out):
    t = out.trace
    if t is None or out.window.unit != "frame" or not t.busy_s:
        return None
    return 1e3 * t.busy_s / t.units
