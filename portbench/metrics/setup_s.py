"""setup_s (end to end, host clock): from the start of the process to the
first timed frame or step: imports, builds where the cache is cold, the
scene, captures, warm-up."""


def read(out):
    return out.window.setup_s
