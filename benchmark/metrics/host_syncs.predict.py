"""Points a call of Retinanet.predict waits for the device (pageable
uploads, reads to the host): the program's ``host_syncs`` counter over the
pass's calls, a call's share (every call of the pass runs the same path;
rnbench/spans.py). The program counts none where nothing waits (the CPU)."""

from rnbench import spans

LAYER = "host front"
UNIT = "count"
MOVES = "predict_img_s"
SOURCE = "program_span"


def read(run):
    result = spans.program_pass(run)
    if not result:
        return None
    return result["records"]["counters"].get("host_syncs", 0) / result["calls"]
