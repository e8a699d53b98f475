"""host_ms.frame (entry layer, host clock): the mean host time inside the
frame's entry call, models/whitted.render_image, from issue to return,
over the measured window's frames (the benchmark's own spans)."""


def read(out):
    w = out.window
    if w.unit != "frame" or not w.host_s:
        return None
    return 1e3 * sum(w.host_s) / len(w.host_s)
