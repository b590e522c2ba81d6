"""Training: losses, AdamW with layer decay, the train step, the loop.

Counterpart of `iggt_official_tpu/train/` on one card (the mesh, FSDP and
tensor-parallel paths are ROADMAP A5).  The step trains through plain
PyTorch attention under autograd, as the JAX step trains through XLA: no
hand-written kernel has a backward (nor has any Pallas kernel of the JAX
package a VJP), and the kernel wrappers refuse inputs that require grad.
"""

from iggt_official_tpu_torch.train.losses import (
    camera_loss,
    conf_regression_loss,
    part_embedding_loss,
    total_loss,
)
from iggt_official_tpu_torch.train.step import (
    AdamWLayerDecay,
    make_optimizer,
    make_schedule,
    make_train_step,
)

__all__ = [
    "AdamWLayerDecay",
    "camera_loss",
    "conf_regression_loss",
    "make_optimizer",
    "make_schedule",
    "make_train_step",
    "part_embedding_loss",
    "total_loss",
]
