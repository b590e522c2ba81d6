"""heads_ms_per_view.fwd: device milliseconds of the traced window's
operations launched inside any of the program's head spans (camera, depth,
point, track and part heads, each whole), per view.  None where no
operation carries one."""

from perfbench.spans import in_heads


def read(tr, facts):
    t = tr.time_of(lambda name, stack: in_heads(stack))
    if t <= 0 or not facts.get("views"):
        return None
    return 1e3 * t / facts["views"]
