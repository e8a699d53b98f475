"""scatter_ms.step (gradient layer, profiler): device ms a traced train
step in the scatter-add kernels of the backward (index_add_ and its kin,
by name)."""

KERNELS = ("indexFunc", "index_add", "scatter_add", "indexing_backward")


def read(out):
    t = out.trace
    if t is None or out.window.unit != "step":
        return None
    ms = t.kernels_ms(KERNELS)
    return ms if ms > 0 else None
