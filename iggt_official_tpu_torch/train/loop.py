"""The training loop: data -> train step -> telemetry -> checkpoints.

Counterpart of `iggt_official_tpu/train/loop.py::train` on one card (its
mesh branches are ROADMAP A5): the model is initialized from the seed (or
given), the first batch is drawn before the first step (``init_batch``),
`MetricLogger` prints every ``log_every`` steps, a checkpoint
(`utils/checkpoint.py::save_checkpoint`, ``step_%08d.pt``) is written every
``checkpoint_every`` steps and at the end, and a run resumes from the newest
``step_*`` in ``checkpoint_dir``.  Batches go numpy -> pinned host memory ->
the card (``non_blocking``).

Each step's record in `TrainState.history` holds its step number, learning
rate, the metrics, the wall time (after a device synchronize) and the time
spent waiting for the batch (the loader and the copy to the card).
"""

from __future__ import annotations

import dataclasses
import os
import re
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from iggt_official_tpu_torch.config import ModelConfig
from iggt_official_tpu_torch.train.step import AdamWLayerDecay, make_optimizer, make_train_step
from iggt_official_tpu_torch.utils.checkpoint import load_training_checkpoint, save_checkpoint
from iggt_official_tpu_torch.utils.device import resolve_device
from iggt_official_tpu_torch.utils.logging import MetricLogger, profile_trace

_CKPT_RE = re.compile(r"^step_(\d{8})\.pt$")


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: AdamWLayerDecay
    history: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    checkpoints: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    profile: Any = None


def to_device(batch: Mapping[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device`` (through pinned memory to a card)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def latest_checkpoint(checkpoint_dir: str) -> Optional[str]:
    if not os.path.isdir(checkpoint_dir):
        return None
    steps = sorted(d for d in os.listdir(checkpoint_dir) if _CKPT_RE.match(d))
    return os.path.join(checkpoint_dir, steps[-1]) if steps else None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(
    model: Union[ModelConfig, nn.Module],
    batches: Iterable[Dict[str, np.ndarray]],
    num_steps: int,
    *,
    init_batch: Optional[Dict[str, np.ndarray]] = None,
    device: Optional[Union[str, torch.device]] = None,
    base_lr: float = 1e-4,
    weight_decay: float = 0.05,
    layer_decay: Optional[float] = 0.9,
    num_layers: int = 24,
    warmup_steps: int = 1000,
    grad_clip: float = 1.0,
    loss_weights: Optional[Dict[str, float]] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1000,
    resume: bool = True,
    log_every: int = 50,
    rng_seed: int = 0,
    print_fn=print,
    args: Optional[Mapping[str, Any]] = None,
    profile_step: Optional[int] = None,
) -> TrainState:
    """Run training up to step ``num_steps``; returns the final TrainState.

    ``model``: a `ModelConfig` (built on ``device`` from ``rng_seed`` with
    gradients on) or a module (trained as it is, on its device).
    ``profile_step``: that step runs under `torch.profiler` (its averaged
    events in ``TrainState.profile``)."""
    from iggt_official_tpu_torch.models.vggt import build_model

    batches = iter(batches)
    if init_batch is None:
        init_batch = next(batches)
    if isinstance(model, ModelConfig):
        model = build_model(model, device=resolve_device(device), seed=rng_seed, train=True)
    else:
        model.train().requires_grad_(True)
    dev = next(model.parameters()).device

    optimizer = make_optimizer(model, base_lr=base_lr, weight_decay=weight_decay,
                               layer_decay=layer_decay, num_layers=num_layers,
                               warmup_steps=warmup_steps, total_steps=num_steps,
                               grad_clip=grad_clip)
    state = TrainState(0, model, optimizer)

    start_step = 0
    if checkpoint_dir and resume:
        latest = latest_checkpoint(checkpoint_dir)
        if latest is not None:
            ckpt = load_training_checkpoint(latest)
            model.load_state_dict(ckpt["model"], strict=True)
            optimizer.load_state_dict(ckpt["optimizer"])
            start_step = state.step = int(ckpt["step"])
            del ckpt
            print_fn(f"resumed from {latest} at step {start_step}")

    step_fn = make_train_step(model, optimizer, loss_weights=loss_weights)
    logger = MetricLogger(print_fn=print_fn)
    saved_at = start_step if checkpoint_dir and start_step else None
    for step_idx in range(start_step, num_steps):
        t0 = time.perf_counter()
        batch = init_batch if step_idx == start_step and start_step == 0 else next(batches)
        batch = to_device(batch, dev)
        _sync(dev)
        t_data = time.perf_counter() - t0
        lr = optimizer.schedule(optimizer.count)
        if step_idx == profile_step:
            with profile_trace() as prof:
                loss, metrics = step_fn(batch)
            state.profile = prof.key_averages()
        else:
            loss, metrics = step_fn(batch)
        _sync(dev)
        metrics = {k: float(v) for k, v in metrics.items()}
        state.step = step_idx + 1
        state.history.append({"step": step_idx, "lr": lr, "wall_s": time.perf_counter() - t0,
                              "data_s": t_data, **metrics})
        logger.update(**metrics)
        if step_idx % log_every == 0:
            print_fn(f"step {step_idx}: {logger}")
        if checkpoint_dir and (step_idx + 1) % checkpoint_every == 0:
            state.checkpoints.append(_save(checkpoint_dir, step_idx + 1, state, args))
            saved_at = step_idx + 1
    if checkpoint_dir and saved_at != num_steps:
        state.checkpoints.append(_save(checkpoint_dir, num_steps, state, args))
    return state


def _save(checkpoint_dir: str, step: int, state: TrainState,
          args: Optional[Mapping[str, Any]]) -> Dict[str, Any]:
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, f"step_{step:08d}.pt")
    t0 = time.perf_counter()
    save_checkpoint(path, state.model, state.optimizer.state_dict(), step, args)
    return {"path": path, "step": step, "seconds": time.perf_counter() - t0,
            "bytes": os.path.getsize(path)}
