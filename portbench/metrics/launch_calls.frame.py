"""launch_calls.frame (compile layer, profiler): host kernel-launch and
graph-launch calls a traced frame."""


def read(out):
    t = out.trace
    if t is None or out.window.unit != "frame":
        return None
    return t.launch_calls / t.units
