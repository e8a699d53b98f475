"""k1_roofline (kernel layer, profiler): the Whitted kernel's least time on
the traced steps' forwards (portbench/work.whitted_work, counted by the
plain reference's stepping) over its measured device time, in %."""

KERNELS = ("whitted_kernel",)


def read(out):
    t = out.trace
    if t is None:
        return None
    ms = t.kernels_ms(KERNELS)
    bound = out.work("k1")
    if ms <= 0 or bound is None:
        return None
    return 100.0 * bound / t.units / ms
