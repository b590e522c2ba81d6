"""Training CLI: dataset expression -> the train loop on one card.

Counterpart of `iggt_official_tpu/app/train.py`:

    python -m iggt_official_tpu_torch.app.train \\
        --dataset "1000 @ Scannet('/data/scannet', resolution=(224,168))" \\
        --steps 10000 --batch_size 8 --checkpoint_dir ckpt

- dataset expressions use the EasyDataset algebra over the registered loader
  classes (`N @ ds`, `ds1 + ds2`), evaluated against the port's
  `data/datasets.py`;
- the model scale knobs (``--embed_dim --depth --num_heads --img_size
  --patch_embed``) and ``--model vggt`` behave as in the JAX CLI; the
  default is the full-width flagship;
- ``--device`` (default ``cuda``) picks the card or, for a debug run, the CPU;
- the port trains on one card: ``--n_seq``, ``--n_model`` and ``--n_data``
  above 1 and ``--fsdp`` (the JAX CLI's mesh, ROADMAP A5) raise an error;
- ``--profile_step N``: step N runs under torch.profiler (its averaged
  events are kept in the returned state's ``profile``).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence


def build_config(args):
    from iggt_official_tpu_torch.config import ModelConfig

    cfg = ModelConfig()
    if args.embed_dim is not None:
        cfg = cfg.scaled(
            embed_dim=args.embed_dim,
            depth=args.depth or 24,
            num_heads=args.num_heads or max(1, args.embed_dim // 64),
            img_size=args.img_size,
            patch_embed=args.patch_embed,
        )
    if args.model == "vggt":
        cfg = dataclasses.replace(cfg, enable_part=False, name="vggt")
    return cfg


def check_single_card(args) -> None:
    """The mesh flags of the JAX CLI, refused: the port trains on one card."""
    wide = [f"--{k} {getattr(args, k)}" for k in ("n_seq", "n_model", "n_data")
            if getattr(args, k) is not None and getattr(args, k) > 1]
    if args.fsdp:
        wide.append("--fsdp")
    if wide:
        raise SystemExit(f"{' '.join(wide)}: the port trains on one card; multi-device "
                         "training (the JAX CLI's mesh, FSDP and tensor parallelism) is "
                         "ROADMAP A5, not ported yet")


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="IGGT trainer (PyTorch, one card)")
    p.add_argument("--dataset", required=True,
                   help="dataset expression over the registered loaders, "
                        "e.g. \"100 @ Scannet('/data/scannet')\"")
    p.add_argument("--steps", type=int, required=True)
    p.add_argument("--batch_size", type=int, default=8,
                   help="images per batch (sampler splits anchors x views)")
    p.add_argument("--seq_min_len", type=int, default=2)
    p.add_argument("--seq_max_len", type=int, default=8)
    p.add_argument("--model", choices=("iggt", "vggt"), default="iggt")
    p.add_argument("--base_lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--layer_decay", type=float, default=0.9)
    p.add_argument("--warmup_steps", type=int, default=1000)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--checkpoint_every", type=int, default=1000)
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n_seq", type=int, default=1, help="must be 1 (ROADMAP A5)")
    p.add_argument("--n_model", type=int, default=1, help="must be 1 (ROADMAP A5)")
    p.add_argument("--n_data", type=int, default=None, help="1 or unset (ROADMAP A5)")
    p.add_argument("--fsdp", action="store_true", help="not supported (ROADMAP A5)")
    # debug-scale model knobs (default: full-scale flagship)
    p.add_argument("--embed_dim", type=int, default=None)
    p.add_argument("--depth", type=int, default=None)
    p.add_argument("--num_heads", type=int, default=None)
    p.add_argument("--img_size", type=int, default=518)
    p.add_argument("--patch_embed", default="dinov2_vitl14_reg")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--profile_step", type=int, default=None)
    args = p.parse_args(argv)
    check_single_card(args)

    from iggt_official_tpu_torch.data.loader import get_data_loader
    from iggt_official_tpu_torch.train.loop import train
    from iggt_official_tpu_torch.utils.device import resolve_device

    cfg = build_config(args)
    device = resolve_device(args.device)
    batches = get_data_loader(
        args.dataset,
        seq_min_len=args.seq_min_len,
        seq_max_len=args.seq_max_len,
        batch_size=args.batch_size,
    )
    state = train(
        cfg,
        batches,
        num_steps=args.steps,
        device=device,
        base_lr=args.base_lr,
        weight_decay=args.weight_decay,
        layer_decay=args.layer_decay,
        num_layers=cfg.aggregator.depth,
        warmup_steps=args.warmup_steps,
        grad_clip=args.grad_clip,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        resume=not args.no_resume,
        log_every=args.log_every,
        rng_seed=args.seed,
        args=vars(args),
        profile_step=args.profile_step,
    )
    print(f"finished at step {state.step}")
    return state


if __name__ == "__main__":
    main()
