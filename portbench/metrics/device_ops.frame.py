"""device_ops.frame (tile and frame layer, profiler): device operations
(kernels, copies, sets) a traced frame."""


def read(out):
    t = out.trace
    if t is None or out.window.unit != "frame" or not t.device_ops:
        return None
    return t.device_ops / t.units
