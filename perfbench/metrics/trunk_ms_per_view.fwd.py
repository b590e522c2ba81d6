"""trunk_ms_per_view.fwd: device milliseconds of the traced window's
operations launched inside the program's ``model.trunk`` span (the
aggregator: patch embedding, RoPE tables, frame and global blocks), per
view.  None where no operation carries the span."""

from perfbench.spans import TRUNK


def read(tr, facts):
    t = tr.time_of(lambda name, stack: TRUNK in stack)
    if t <= 0 or not facts.get("views"):
        return None
    return 1e3 * t / facts["views"]
