"""conv_ms_per_view.fwd: device milliseconds of the operations launched
inside a convolution op (the heads' convolutions and transposed
convolutions, the DINOv2 patch embedding), per view of the traced window."""

CONV_OPS = {"aten::convolution", "aten::_convolution", "aten::conv2d",
            "aten::conv_transpose2d", "aten::cudnn_convolution",
            "aten::cudnn_convolution_transpose"}


def read(tr, facts):
    t = tr.time_of(lambda name, stack: any(s in CONV_OPS for s in stack))
    if t <= 0 or not facts.get("views"):
        return None
    return 1e3 * t / facts["views"]
