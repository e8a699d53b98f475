"""graph_host_ms.frame (compile layer, host clock, spans window): the mean
host time a frame inside the program's rt.call spans
(utils/graphs.GraphCache.call) less their rt.launch spans: the signature,
the copy-in and the outputs, over the spans window's frames
(portbench/spans.py)."""
from portbench import spans


def read(out):
    if out.window.unit != "frame":
        return None
    return spans.measured(out).get("graph_host_ms")
