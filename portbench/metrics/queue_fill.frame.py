"""queue_fill.frame (tile-and-frame layer, the wavefront queue's device
counter): the live entries of the queue's rounds after the first over the
entries those rounds offer (capacity x rounds), over the spans window's
frames, in % (models/whitted_wavefront.live_counter; portbench/spans.py).
None where the frame has no such rounds."""
from portbench import spans


def read(out):
    if out.window.unit != "frame":
        return None
    return spans.measured(out).get("queue_fill")
