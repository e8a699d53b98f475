"""launch_ms.frame (compile layer, host clock, spans window): the mean
host time a frame inside the program's rt.launch spans (utils/graphs: the
CUDA graph's replay, cudaGraphLaunch), over the spans window's frames, no
profiler (portbench/spans.py)."""
from portbench import spans


def read(out):
    if out.window.unit != "frame":
        return None
    return spans.measured(out).get("launch_ms")
