"""Share of the download-slot pool in use while rows are live: the
program's ``slot_busy`` counter (slots occupied in live rows, summed
over the steps, counted on the device) over the rows' own ``n_steps``
x the pool's ``DOWNLOAD_SLOTS`` x W slots.  ``None`` where the program
keeps no such counter."""
from perfbench.readers import DOWNLOAD_SLOTS, calls_of
from perfbench.spans import counter, window_calls


def read(run):
    calls = window_calls(run, "grid")
    if calls is None or any("slot_busy" not in r["counters"]
                            for c in calls for r in c
                            if r["name"] == "drive"):
        return None
    row_steps = sum(c["row_steps"] for c in calls_of(run, "grid"))
    lanes = row_steps * DOWNLOAD_SLOTS * run["W"]
    return counter(calls, "slot_busy") / lanes if lanes else None
