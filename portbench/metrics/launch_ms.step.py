"""launch_ms.step (compile layer, host clock, spans window): the mean host
time a step inside the program's rt.launch spans (utils/graphs: the CUDA
graph's replay, cudaGraphLaunch), over the spans window's steps, no
profiler (portbench/spans.py)."""
from portbench import spans


def read(out):
    if out.window.unit != "step":
        return None
    return spans.measured(out).get("launch_ms")
