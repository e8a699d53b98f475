"""brute_roofline (kernel layer, profiler): the brute-force queries' least
time on the traced frames (portbench/work.brute_work, each test charged
where the plain reference's staging ended it) over the brute-force
kernels' measured device time (packing and tests), in %."""

KERNELS = ("brute_",)


def read(out):
    t = out.trace
    if t is None:
        return None
    ms = t.kernels_ms(KERNELS)
    bound = out.work("brute")
    if ms <= 0 or bound is None:
        return None
    return 100.0 * bound / t.units / ms
