"""launch_calls.step (compile layer, profiler): host kernel-launch and
graph-launch calls a traced train step."""


def read(out):
    t = out.trace
    if t is None or out.window.unit != "step":
        return None
    return t.launch_calls / t.units
