"""Share of the input-edge lanes the step carries that are padding:
1 - the program's ``valid_edges`` (the rows' real input edges) over
its ``edge_lanes`` (rows x the bucket's padded E), summed over the
window's simulator calls.  ``None`` where the program keeps no such
counter."""
from perfbench.spans import counter, window_calls


def read(run):
    calls = window_calls(run, "grid")
    if calls is None or any("edge_lanes" not in r["counters"]
                            for c in calls for r in c
                            if r["name"] == "drive"):
        return None
    lanes = counter(calls, "edge_lanes")
    return 1.0 - counter(calls, "valid_edges") / lanes if lanes else None
