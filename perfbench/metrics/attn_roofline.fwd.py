"""attn_roofline.fwd: the trunk's bf16 attentions (24 DINOv2, 24 frame,
24 global blocks a forward): the sum of their least times on one H100,
max(operations / 989 TF/s, bytes / 3.35 TB/s) counted from the shapes
(`perfbench/flops.py::AttentionCall`), over the device time of the kernels
they launch, by name: the bf16 flash kernel and the fused calls' q/k prep
(`csrc/flash_attention.cu`).  The part head's fp32 kernels are not of them."""

KERNELS = ("flash_kernel_wgmma", "flash_kernel_qk_prep")


def read(tr, facts):
    t = tr.time_of(lambda name, stack: any(k in name for k in KERNELS))
    if t <= 0:
        return None
    bound = facts["requests"] * sum(c.bound_s() for c in facts["attention_calls"])
    return 100.0 * bound / t
