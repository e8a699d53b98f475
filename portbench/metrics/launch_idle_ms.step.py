"""launch_idle_ms.step (device layer, profiler): the device's idle time a
step inside the program's rt.launch ranges, over the traffic's traced
steps under the profiler with the program's spans on (portbench/spans.py)."""
from portbench import spans


def read(out):
    if out.window.unit != "step":
        return None
    return spans.measured(out).get("launch_idle_ms")
