"""host_ms.step (entry layer, host clock): the mean host time inside the
compiled train step's call, from issue to return, before the loss is
read, over the measured window's steps (the benchmark's own spans)."""


def read(out):
    w = out.window
    if w.unit != "step" or not w.host_s:
        return None
    return 1e3 * sum(w.host_s) / len(w.host_s)
