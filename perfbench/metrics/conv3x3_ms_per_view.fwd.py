"""conv3x3_ms_per_view.fwd: device milliseconds of the traced window's
operations launched inside the program's ``ops.conv3x3`` span (the heads' 3x3,
stride-1 convolutions that the program runs on its own kernel: the weight
split, the convolution and any copy around them), per view.  None where no
operation carries the span."""

# the span's name as the program opens it (iggt_official_tpu_torch/ops/conv.py)
SPAN = "ops.conv3x3"


def read(tr, facts):
    t = tr.time_of(lambda name, stack: SPAN in stack)
    if t <= 0 or not facts.get("views"):
        return None
    return 1e3 * t / facts["views"]
