"""accel_ms.frame (accelerator layer, profiler): device ms a traced frame
in the traversal kernels, by the names the configuration lists under
``accel_kernels``."""


def read(out):
    t = out.trace
    parts = out.config.get("accel_kernels")
    if t is None or out.window.unit != "frame" or not parts:
        return None
    ms = t.kernels_ms(parts)
    return ms if ms > 0 else None
