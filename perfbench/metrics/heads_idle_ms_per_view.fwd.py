"""heads_idle_ms_per_view.fwd: idle milliseconds of the traced window, per
view, in the gaps whose next device operation was launched inside one of
the program's head spans.  Gaps are found as `trace.py::breakdown` finds
them: before each of the window's merged busy intervals, named by the
operation that opens it; the window's tail after the last operation counts
for no layer.  The traced window carries the profiler's host cost on every
op, so this reads above what an un-profiled run idles: compare it parent
against change, never with ``device_idle_share.fwd``.  None where no
operation carries a head span."""

import bisect

from perfbench.spans import in_heads


def read(tr, facts):
    if not facts.get("views") or not any(in_heads(o.stack) for o in tr.ops):
        return None
    starts = [o.start for o in tr.ops]
    idle, prev_end = 0.0, tr.window[0]
    for s, e in tr.busy:
        if s > prev_end and in_heads(tr.ops[bisect.bisect_left(starts, s)].stack):
            idle += s - prev_end
        prev_end = e
    return 1e3 * idle / facts["views"]
