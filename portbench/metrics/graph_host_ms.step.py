"""graph_host_ms.step (compile layer, host clock, spans window): the mean
host time a step inside the program's rt.call spans
(utils/graphs.GraphCache.call) less their rt.launch spans: the signature,
the copy-in and the outputs, over the spans window's steps
(portbench/spans.py)."""
from portbench import spans


def read(out):
    if out.window.unit != "step":
        return None
    return spans.measured(out).get("graph_host_ms")
