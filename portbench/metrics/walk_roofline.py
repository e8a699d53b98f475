"""walk_roofline (kernel layer, profiler): the BVH walk's least time on the
traced frames' queries (portbench/work.walk_work, counted by the plain
reference) over the walk kernels' measured device time, in %."""

KERNELS = ("closest_kernel", "any_kernel")


def read(out):
    t = out.trace
    if t is None:
        return None
    ms = t.kernels_ms(KERNELS)
    bound = out.work("walk")
    if ms <= 0 or bound is None:
        return None
    return 100.0 * bound / t.units / ms
