"""frame_p95_ms (end to end, host clock): the 95th percentile, nearest
rank, over every frame of the window, of a frame's latency from its issue
to its 8-bit image on the host."""
import math


def read(out):
    w = out.window
    if w.unit != "frame" or not w.count:
        return None
    lat = sorted(w.latency_s)
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
