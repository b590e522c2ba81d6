"""Multi-task training losses for VGGT / IGGT, on tensors, in fp32.

Counterpart of `iggt_official_tpu/train/losses.py`:

- camera: per-iteration smooth-L1 on the 9-D pose encoding, iteration i of
  n weighted gamma^(n-1-i);
- depth / world points: confidence-weighted regression
  conf * |err| - alpha * log(conf) over the valid pixels;
- part embeddings: a pull / push loss on the L2-normalized 8-D embeddings of
  every 4th pixel (each way) against the instance ids (-1 = ignore).

`part_embedding_loss` gives the JAX function's value without its (B, n, n)
matrices: at 4 views of 518x392 n = 50,960, and one such fp32 matrix is
10.4 GB.  Over the valid pixels the pull sum is, per instance,
n_id^2 - |sum of its f_i|^2 (O(n C)); the denominator is (#valid)^2; the
push sum max(f_i . f_j - margin, 0) over pairs of different ids runs over
blocks of ``block_rows`` rows, each recomputed in the backward pass
(`torch.utils.checkpoint`), so one (block_rows, n) tile lives at a time.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

PART_BLOCK_ROWS = 2048


def smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def camera_loss(pose_enc_list: Sequence[torch.Tensor], gt_pose_enc: torch.Tensor,
                gamma: float = 0.8) -> torch.Tensor:
    """Iteration-weighted smooth-L1 over the pose encodings (B, S, 9)."""
    n = len(pose_enc_list)
    total = 0.0
    wsum = 0.0
    for i, pred in enumerate(pose_enc_list):
        w = gamma ** (n - 1 - i)
        total = total + w * smooth_l1(pred.float() - gt_pose_enc).mean()
        wsum += w
    return total / wsum


def conf_regression_loss(pred: torch.Tensor, conf: torch.Tensor, gt: torch.Tensor,
                         valid: torch.Tensor, alpha: float = 0.2) -> torch.Tensor:
    """conf * |e| - alpha * log(conf) over the valid pixels.

    pred / gt: (..., C); conf: (...) > 0; valid: (...) bool or 0 / 1."""
    err = (pred.float() - gt).abs().mean(-1)
    conf = conf.float()
    per_pixel = conf * err - alpha * torch.log(torch.clamp(conf, min=1e-6))
    valid = valid.to(per_pixel.dtype)
    return (per_pixel * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def _push_block(f_rows, ids_rows, f, ids, margin: float) -> torch.Tensor:
    """Sum of max(f_i . f_j - margin, 0) over the pairs of different ids with
    i in the block and j anywhere (all rows valid)."""
    sim = f_rows @ f.T
    return (torch.clamp(sim - margin, min=0.0) * (ids_rows[:, None] != ids[None, :])).sum()


def part_embedding_loss(feat: torch.Tensor, instance_ids: torch.Tensor, stride: int = 4,
                        margin: float = 0.5,
                        block_rows: int = PART_BLOCK_ROWS) -> torch.Tensor:
    """Pairwise pull / push loss on normalized embeddings.

    feat: (B, S, H, W, C); instance_ids: (B, S, H, W) int (-1 = ignore).  Same-id
    pairs are pulled to cosine similarity 1, different-id pairs pushed below
    ``margin``; the mean is over the valid pairs of every batch entry."""
    f = feat[:, :, ::stride, ::stride].float()
    ids = instance_ids[:, :, ::stride, ::stride]
    B = f.shape[0]
    f = f.reshape(B, -1, f.shape[-1])
    f = f / torch.clamp(torch.linalg.vector_norm(f, dim=-1, keepdim=True), min=1e-6)
    ids = ids.reshape(B, -1).to(device=f.device, dtype=torch.long)

    pull = f.new_zeros((), dtype=torch.float64)
    push = f.new_zeros(())
    pairs = 0
    for b in range(B):
        valid = ids[b] >= 0
        fv, iv = f[b][valid], ids[b][valid]
        n = fv.shape[0]
        pairs += n * n
        if n == 0:
            continue
        # pull: sum over ids of n_id^2 - |sum f_i|^2, in float64 (it cancels)
        _, inverse, counts = torch.unique(iv, return_inverse=True, return_counts=True)
        sums = torch.zeros((counts.shape[0], fv.shape[1]), dtype=torch.float64,
                           device=f.device).index_add_(0, inverse, fv.double())
        pull = pull + (counts.double() ** 2).sum() - (sums * sums).sum()
        # push: row blocks, recomputed in the backward pass
        for r in range(0, n, block_rows):
            args = (fv[r:r + block_rows], iv[r:r + block_rows], fv, iv, margin)
            if torch.is_grad_enabled() and fv.requires_grad:
                push = push + checkpoint(_push_block, *args, use_reentrant=False)
            else:
                push = push + _push_block(*args)
    return (pull.float() + push) / max(float(pairs), 1.0)


def total_loss(preds: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
               weights: Dict[str, float] | None = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Combine the task losses present in both preds and batch."""
    w = {"camera": 5.0, "depth": 1.0, "point": 1.0, "part": 1.0}
    if weights:
        w.update(weights)
    metrics: Dict[str, torch.Tensor] = {}
    device = batch["images"].device if "images" in batch else None
    loss = torch.zeros((), dtype=torch.float32, device=device)

    if "pose_enc_list" in preds and "pose_enc" in batch:
        lc = camera_loss(preds["pose_enc_list"], batch["pose_enc"])
        metrics["loss/camera"] = lc
        loss = loss + w["camera"] * lc
    if "depth" in preds and "depth" in batch:
        ld = conf_regression_loss(preds["depth"], preds["depth_conf"], batch["depth"],
                                  batch["valid_mask"])
        metrics["loss/depth"] = ld
        loss = loss + w["depth"] * ld
    if "world_points" in preds and "world_points" in batch:
        lp = conf_regression_loss(preds["world_points"], preds["world_points_conf"],
                                  batch["world_points"], batch["valid_mask"])
        metrics["loss/point"] = lp
        loss = loss + w["point"] * lp
    if "part_feat" in preds and "instance_ids" in batch:
        lpart = part_embedding_loss(preds["part_feat"], batch["instance_ids"])
        metrics["loss/part"] = lpart
        loss = loss + w["part"] * lpart

    metrics["loss/total"] = loss
    return loss, metrics
