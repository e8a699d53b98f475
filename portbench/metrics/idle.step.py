"""idle.step (device layer, profiler): the share of the traced steps'
window in which the device ran nothing, in %, averaged over the ranks."""


def read(out):
    t = out.trace
    if t is None or out.window.unit != "step" or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
