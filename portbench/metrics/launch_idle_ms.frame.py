"""launch_idle_ms.frame (device layer, profiler): the device's idle time a
frame inside the program's rt.launch ranges, over the traffic's traced
frames under the profiler with the program's spans on
(portbench/spans.py)."""
from portbench import spans


def read(out):
    if out.window.unit != "frame":
        return None
    return spans.measured(out).get("launch_idle_ms")
