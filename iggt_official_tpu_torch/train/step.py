"""The training step: AdamW with ViT layer decay and a warmup-cosine schedule.

Counterpart of `iggt_official_tpu/train/step.py`.  The optimizer is optax's
chain, written by hand on `torch._foreach_*` so that it matches it step for
step:

1. ``clip_by_global_norm(grad_clip)``: g / |g| * grad_clip when |g| is not
   below grad_clip (`torch.nn.utils.clip_grad_norm_` divides by |g| + 1e-6
   instead);
2. ``scale_by_adam(b1=0.9, b2=0.95, eps=1e-8)`` with bias correction;
3. ``add_decayed_weights(weight_decay)`` on the parameters of the decay mask;
4. the layer-decay scale layer_decay ** (num_layers - layer_id);
5. the learning rate, the schedule taken at the update count *before* this
   update (optax's ``scale_by_learning_rate``), so the first update runs at
   ``min_lr``.

A parameter that got no gradient (``cross_attention_1`` of the part head,
which the JAX package computes and discards) is updated with a zero
gradient, weight decay included, as optax updates it.  The parameters'
``.grad`` stay as the backward pass left them (unclipped) until the next
step.

The step trains through `layers/blocks.py::sdpa_plain` in the trunk and the
DINOv2 blocks, with the frame and global blocks rematerialized, as the JAX
step applies the model with ``remat=True`` and its default ``sdpa_xla``.
The part head's cross-attention keeps the JAX package's dispatcher there,
which on a TPU sends the level-1x injection (512-2048 tokens; 1,036 at
518x392) to the Pallas flash kernel, a kernel without a VJP; the step sends
it to `ops/flash_attention.py::attention_train`: the flash kernel's forward
on the card, and the backward of its plain version (no backward kernel).

On a mesh (``make_train_step(..., mesh=mesh, fsdp=...)`` on a model laid out
by `parallel/mesh.py::parallelize`): each rank takes its data group's batch
entries and its seq rank's views; the global blocks attend through the
all-gather wrapper of `parallel/attention.py` over ``attn_fn``; the losses
keep the global normalization (`train/losses.py::GlobalSums`); the gradients
are averaged over the data x seq ranks (FSDP's reduce-scatter averages over
"data", the rest is all-reduced here), as GSPMD's gradient of the global mean;
and the optimizer steps on each rank's part of each parameter (its FSDP shard,
its tensor-parallel slice), the global norm summed over the world with each
part counted once.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from iggt_official_tpu_torch.layers.blocks import sdpa_plain
from iggt_official_tpu_torch.models.vggt import IGGT
from iggt_official_tpu_torch.ops.flash_attention import attention_train
from iggt_official_tpu_torch.parallel.attention import make_mesh_attention_fns
from iggt_official_tpu_torch.parallel.comm import AxisGroup
from iggt_official_tpu_torch.parallel.mesh import ParallelPlan, local_tensor
from iggt_official_tpu_torch.train.losses import GlobalSums, total_loss
from iggt_official_tpu_torch.utils.logging import span

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.95, 1e-8
# numel of the parameters updated together: bounds the update's temporaries
_CHUNK_NUMEL = 1 << 26
# a step's spans under a profiler (`utils/logging.py::span`), in their order
FORWARD_SPAN = "train.forward"
LOSS_SPAN = "train.loss"
BACKWARD_SPAN = "train.backward"
OPTIMIZER_SPAN = "train.optimizer"


def make_schedule(base_lr: float = 1e-4, warmup_steps: int = 1000,
                  total_steps: int = 100_000, min_lr: float = 1e-6) -> Callable[[int], float]:
    """optax ``warmup_cosine_decay_schedule(min_lr, base_lr, warmup_steps,
    total_steps, min_lr)`` as a function of the step: linear warmup from
    ``min_lr`` (the first step is not a no-op), then cosine decay to
    ``min_lr`` at ``total_steps`` (which counts the warmup).  Computed in
    float32, as optax computes it (the warmup's (min_lr - base_lr) * frac +
    base_lr loses ~1e-6 of its value to float32 rounding there)."""
    decay_steps = total_steps - warmup_steps
    if decay_steps <= 0:
        raise ValueError(f"the cosine decay needs total_steps > warmup_steps, got "
                         f"{total_steps} <= {warmup_steps}")
    f32 = np.float32
    alpha = 0.0 if base_lr == 0.0 else min_lr / base_lr

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = f32(1) - f32(min(max(step, 0), warmup_steps)) / f32(warmup_steps)
            return float(f32(min_lr - base_lr) * frac + f32(base_lr))
        count = f32(min(step - warmup_steps, decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * count / f32(decay_steps)))
        return float(f32(base_lr) * (f32(1.0 - alpha) * cosine + f32(alpha)))

    return schedule


# the JAX rules read flax paths; the port's names differ from them only in
# dots for slashes, block indices after a dot, and the part head's window
# modules' patch norm (flax ``patch_norm``, torch ``patch_embed.norm``)
_BLOCK_RE = re.compile(r"(?:frame|global)_blocks\.(\d+)|(?<!\w)blocks\.(\d+)")
_WINDOW_PATCH_NORM = re.compile(r"(?<!aggregator)\.patch_embed\.norm\.")


def _flax_like(name: str) -> str:
    return _WINDOW_PATCH_NORM.sub(".patch_norm.", name)


def layer_id(name: str, num_layers: int) -> int:
    """ViT layer id for layer decay: embeddings -> 0, block i -> i + 1,
    everything else -> num_layers (JAX `_layer_id`)."""
    name = _flax_like(name)
    if "patch_embed" in name and "blocks" not in name:
        return 0
    m = _BLOCK_RE.search(name)
    if m:
        return int(m.group(1) or m.group(2)) + 1
    if "aggregator" in name:
        return 0 if ("token" in name or "pos_embed" in name) else num_layers
    return num_layers


def layer_decay_scale(name: str, decay: float = 0.9, num_layers: int = 24) -> float:
    return decay ** (num_layers - layer_id(name, num_layers))


def no_decay(name: str, param: torch.Tensor) -> bool:
    """bias / norm / token parameters are excluded from weight decay (JAX
    `_no_decay`)."""
    name = _flax_like(name).lower()
    return (param.dim() <= 1 or "token" in name or "pos_embed" in name
            or name.endswith("gamma"))


class AdamWLayerDecay:
    """optax's clip -> Adam -> decoupled weight decay -> layer decay -> lr
    chain over a model's named parameters (see the module note).

    ``step()`` reads each parameter's ``.grad`` (None counts as zero),
    updates the parameters in place and returns the pre-clip global norm.
    With a ``plan`` (a model laid out over a mesh) it works on each rank's
    part of every parameter, its moments hold that part, and the global norm
    sums every rank's squares over the world, each part counted once."""

    def __init__(self, named_params, base_lr: float = 1e-4, weight_decay: float = 0.05,
                 layer_decay: Optional[float] = None, num_layers: int = 24,
                 warmup_steps: int = 1000, total_steps: int = 100_000,
                 grad_clip: float = 1.0, plan: Optional[ParallelPlan] = None):
        named = [(n, p) for n, p in named_params if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.plan = plan
        self.norm_weights = None
        if plan is not None:
            self.norm_weights = torch.tensor([1.0 / plan.replicas(n) for n in self.names],
                                             dtype=torch.float64)
        self.schedule = make_schedule(base_lr, warmup_steps, total_steps)
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.decay = [not no_decay(n, p) for n, p in named]
        self.scale = [1.0 if layer_decay is None else layer_decay_scale(n, layer_decay, num_layers)
                      for n, _ in named]
        self.mu = [torch.zeros_like(p) for p in self._locals()]
        self.nu = [torch.zeros_like(p) for p in self._locals()]
        self.count = 0
        # parameters updated by one set of foreach calls: same scale and
        # decay flag, at most _CHUNK_NUMEL elements
        groups: Dict[Tuple[float, bool], List[int]] = {}
        for i in range(len(self.params)):
            groups.setdefault((self.scale[i], self.decay[i]), []).append(i)
        self._chunks = []
        for (scale, decay), idx in groups.items():
            chunk, numel = [], 0
            for i in idx:
                if chunk and numel + self.params[i].numel() > _CHUNK_NUMEL:
                    self._chunks.append((scale, decay, chunk))
                    chunk, numel = [], 0
                chunk.append(i)
                numel += self.params[i].numel()
            self._chunks.append((scale, decay, chunk))

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def _locals(self) -> List[torch.Tensor]:
        """The tensors the update writes: each parameter, or its local shard."""
        if self.plan is None:
            return self.params
        return [local_tensor(p) for p in self.params]

    def _grads(self) -> List[torch.Tensor]:
        return [torch.zeros_like(p) if g is None else local_tensor(g)
                for p, g in zip(self._locals(), (p.grad for p in self.params))]

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        norms = torch.stack(torch._foreach_norm(grads))
        if self.plan is None:
            return torch.linalg.vector_norm(norms)
        sq = (norms.double() ** 2 * self.norm_weights.to(norms.device)).sum()
        if dist.get_world_size() > 1:
            dist.all_reduce(sq)
        return sq.sqrt().float()

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = self._grads()
        gnorm = self._global_norm(grads)
        clip = not bool(gnorm < self.grad_clip)
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = 1.0 - ADAM_B1 ** self.count
        bc2 = 1.0 - ADAM_B2 ** self.count
        local = self._locals()
        for scale, decay, idx in self._chunks:
            params = [local[i] for i in idx]
            mu = [self.mu[i] for i in idx]
            nu = [self.nu[i] for i in idx]
            g = [grads[i] for i in idx]
            if clip:
                g = torch._foreach_div(g, gnorm)
                torch._foreach_mul_(g, self.grad_clip)
            torch._foreach_mul_(mu, ADAM_B1)
            torch._foreach_add_(mu, g, alpha=1.0 - ADAM_B1)
            torch._foreach_mul_(nu, ADAM_B2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - ADAM_B2)
            del g
            upd = torch._foreach_div(mu, bc1)
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, ADAM_EPS)
            torch._foreach_div_(upd, den)
            del den
            if decay and self.weight_decay:
                torch._foreach_add_(upd, params, alpha=self.weight_decay)
            if scale != 1.0:
                torch._foreach_mul_(upd, scale)
            torch._foreach_mul_(upd, -lr)
            torch._foreach_add_(params, upd)
        return gnorm

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    def load_state_dict(self, state: dict) -> None:
        differ = set(self.names) ^ set(state["mu"])
        if differ:
            raise ValueError(f"optimizer state does not match the parameters: "
                             f"{sorted(differ)[:5]}")
        with torch.no_grad():
            for i, n in enumerate(self.names):
                self.mu[i].copy_(state["mu"][n])
                self.nu[i].copy_(state["nu"][n])
        self.count = int(state["count"])


def make_optimizer(model: nn.Module, base_lr: float = 1e-4, weight_decay: float = 0.05,
                   layer_decay: Optional[float] = None, num_layers: int = 24,
                   warmup_steps: int = 1000, total_steps: int = 100_000,
                   grad_clip: float = 1.0) -> AdamWLayerDecay:
    """The optimizer over ``model``'s parameters (their local parts when the
    model was laid out by `parallel/mesh.py::parallelize`)."""
    return AdamWLayerDecay(model.named_parameters(), base_lr, weight_decay, layer_decay,
                           num_layers, warmup_steps, total_steps, grad_clip,
                           getattr(model, "parallel_plan", None))


def _all_reduce_mean(tensors: List[torch.Tensor], axis: AxisGroup) -> None:
    """Average tensors over ``axis`` in place (one flat buffer per dtype)."""
    if axis.size == 1 or not tensors:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=axis.group)
        flat /= axis.size
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


@torch.no_grad()
def average_gradients(model: nn.Module, plan: ParallelPlan) -> None:
    """Average every gradient over the data x seq ranks: FSDP-sharded ones are
    already averaged over "data" by the reduce-scatter, so they go over
    "seq" alone."""
    over_seq, over_dp = [], []
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        sharded = plan.fsdp and plan.specs[name].fsdp_dim is not None
        (over_seq if sharded else over_dp).append(local_tensor(p.grad))
    _all_reduce_mean(over_seq, plan.mesh.seq)
    _all_reduce_mean(over_dp, plan.mesh.dp)


def make_train_step(model: nn.Module, optimizer: AdamWLayerDecay,
                    loss_weights: Optional[Dict[str, float]] = None, remat: bool = True,
                    attn_fn: Callable = sdpa_plain,
                    part_attn_fn: Callable = attention_train,
                    mesh=None, fsdp: bool = False) -> Callable:
    """``step(batch) -> (loss, metrics)``: forward through ``attn_fn`` (the
    part head of an IGGT through ``part_attn_fn``) with the trunk's blocks
    rematerialized, the losses, the backward pass and the optimizer update.
    ``metrics`` holds the loss terms and ``grad_norm``, the pre-clip global
    norm, as detached tensors.

    batch: images (B, S, H, W, 3) and any of pose_enc (B, S, 9), depth
    (B, S, H, W, 1), world_points (B, S, H, W, 3), valid_mask (B, S, H, W),
    instance_ids (B, S, H, W), as tensors on the model's device; on a
    ``mesh``, the rank's batch entries and views of them (the model laid out
    by ``parallelize(model, mesh, fsdp)``, the optimizer made after it), and
    the loss and metrics are the whole batch's, the same on every rank.
    Under a profiler the step's phases are the spans ``train.forward``,
    ``train.loss``, ``train.backward`` (the gradients' averaging over a mesh
    included) and ``train.optimizer``."""

    routes = {"attn_fn": attn_fn}
    if isinstance(model, IGGT):
        routes["part_attn_fn"] = part_attn_fn
    plan = getattr(model, "parallel_plan", None)
    sums = None
    if mesh is not None:
        if plan is None or plan.mesh is not mesh or plan.fsdp != fsdp:
            raise ValueError(f"the model is not laid out over this mesh with fsdp={fsdp}: "
                             "call parallel.mesh.parallelize(model, mesh, fsdp) first")
        frame_fn, global_fn = make_mesh_attention_fns(mesh, attn_fn)
        routes.update(attn_fn=frame_fn, global_attn_fn=global_fn, seq=mesh.seq)
        sums = GlobalSums(mesh)
    elif plan is not None:
        raise ValueError("the model is laid out over a mesh: pass it as mesh=")

    def step(batch: Dict[str, torch.Tensor]):
        optimizer.zero_grad()
        with torch.enable_grad():
            with span(FORWARD_SPAN):
                preds = model(batch["images"], remat=remat, **routes)
            with span(LOSS_SPAN):
                loss, metrics = total_loss(preds, batch, loss_weights, sums)
            del preds
            with span(BACKWARD_SPAN):
                loss.backward()
                if sums is not None:
                    average_gradients(model, plan)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if sums is not None:
            keys = sorted(metrics)
            mean = torch.stack([metrics[k] for k in keys])
            _all_reduce_mean([mean], mesh.dp)
            metrics = dict(zip(keys, mean.unbind(0)))
            loss = metrics["loss/total"]
        with span(OPTIMIZER_SPAN):
            metrics["grad_norm"] = optimizer.step()
        return loss.detach(), metrics

    return step
