"""How full the candidate-flow frontier gets: over the window's
simulator calls, the largest ``frontier_peak`` (the fullest frontier of
a live row in any step, counted on the device) over that call's
``flow_cap`` (the frontier's cap, E with full caps).  A low value means
the step carries empty frontier lanes.  ``None`` where the program
keeps no such counter or no call ran the frontier."""
from perfbench.spans import window_calls


def read(run):
    calls = window_calls(run, "grid")
    drives = [r["counters"] for c in calls or [] for r in c
              if r["name"] == "drive"]
    if not drives or any("frontier_peak" not in d for d in drives):
        return None
    fills = [d["frontier_peak"] / d["flow_cap"] for d in drives
             if d["flow_cap"] > 0]
    return max(fills) if fills else None
