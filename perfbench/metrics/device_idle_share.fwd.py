"""device_idle_share.fwd: the share of the seconds the traced requests take
without the profiler (the un-profiled window, on the host's clock) in which
the device does not work: the device's busy seconds come from the traced
window, whose own span the profiler's host cost stretches.  Reads below 0
where the device's work under the profiler outlasts the un-profiled
window."""


def read(tr, facts):
    if not facts.get("untraced_window_s") or tr.busy_s <= 0:
        return None
    return 100.0 * (facts["untraced_window_s"] - tr.busy_s) / facts["untraced_window_s"]
