"""captures.step (compile layer, the graph cache's counter): the CUDA
graphs the program captured during the spans window
(utils/graphs.CACHE.captures gained; 0 where every step replays its graph)
(portbench/spans.py)."""
from portbench import spans


def read(out):
    if out.window.unit != "step":
        return None
    return spans.measured(out).get("captures")
