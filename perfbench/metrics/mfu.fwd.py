"""mfu.fwd: the forward's model operations (`perfbench/flops.py`) over the
seconds the traced requests take without the profiler (the traced run's
un-profiled window, on the host's clock), as a share of one H100's bf16
dense peak (989 TF/s)."""

from perfbench.flops import PEAK


def read(tr, facts):
    if not facts.get("untraced_window_s") or not facts.get("requests"):
        return None
    return 100.0 * facts["flops_per_request"] * facts["requests"] \
        / facts["untraced_window_s"] / PEAK["bf16_flops"]
