#!/usr/bin/env python3
"""Are merged forwards deterministic, and do any read memory they did not write?

    python3 scripts/merge_determinism.py [--modes checked,unsafe,...] [--forwards 3]

Runs the full-width IGGT (`ModelConfig()`, seeded random weights) on one
seeded 8-view 518x518 stack, merged at `global_merge_r=4096` or exact,
several times in each mode, and compares every forward's outputs with the
reference forward of its kind, run first in a clean process: the merged
one with torch's check of the merge's lengths on, the exact one.  Modes
(`MODE_SPECS`):

- ``checked``: merged, `torch.segment_reduce(..., unsafe=False)`: torch
  checks the lengths on the host, a device sync per call;
- ``unsafe``: merged as shipped (`unsafe=True`, no check, no sync);
- ``unsafe_sync_prep`` / ``_merge`` / ``_flash``: unsafe, with
  `torch.cuda.synchronize()` after each call of that step;
- ``exact``: the unmerged forward;
- ``*_poison_nan`` / ``*_poison_randn``: before each forward, all free
  device memory and the allocator's cached blocks are filled with NaN or
  random values, so a kernel that reads memory it was not given, or
  leaves part of its output unwritten, changes the result.

Each mode's last forward is recorded step by step (q/k/v into the merged
attention, the prepped q and k, merged k and v, the key bias, the attention
output, every frame and global block's output); the first recorded step
whose bytes differ from the reference is printed, with whether the step
before it was equal.  Then the steps of global block 0 run again back to
back on the reference's own inputs, 20 times each, and every result is
compared with the first.  Needs one CUDA card.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from iggt_official_tpu_torch.config import ModelConfig  # noqa: E402
from iggt_official_tpu_torch.models import aggregator as agg_mod  # noqa: E402
from iggt_official_tpu_torch.models.vggt import build_model  # noqa: E402
from iggt_official_tpu_torch.ops import token_merge as tm  # noqa: E402

MERGE_R = 4096

_segment_reduce = torch.segment_reduce
_qk_prep, _merge_kv, _flash = tm.qk_prep, tm.merge_kv, tm.flash_attention


class Recorder:
    """Steps of one forward as (name, tensor clone) pairs, cloned on the
    stream without any host synchronization."""

    def __init__(self):
        self.on = False
        self.steps = []
        self.mode = "checked"

    def add(self, name, *tensors):
        if self.on:
            for i, t in enumerate(tensors):
                self.steps.append((f"{name}[{i}]", t.detach().clone()))

    def block(self):
        """Index of the merged global block now running in this forward."""
        return sum(name.startswith("global block") for name, _ in self.steps)

    def sync(self, step):
        if self.mode.endswith(f"_sync_{step}"):
            torch.cuda.synchronize()


REC = Recorder()


def segment_reduce(*args, **kwargs):
    kwargs["unsafe"] = REC.mode.startswith("unsafe")
    return _segment_reduce(*args, **kwargs)


def qk_prep(q, k, *args, **kwargs):
    REC.add(f"g{REC.block()} attn in q,k", q, k)
    if REC.on and not hasattr(REC, "prep_args"):
        REC.prep_args = args
    out = _qk_prep(q, k, *args, **kwargs)
    REC.sync("prep")
    REC.add(f"g{REC.block()} prep out q,k", *out)
    return out


def merge_kv(k, v, *args, **kwargs):
    REC.add(f"g{REC.block()} merge in v", v)
    out = _merge_kv(k, v, *args, **kwargs)
    REC.sync("merge")
    REC.add(f"g{REC.block()} merge out k,v,bias", *out)
    return out


def flash_attention(q, k, v, key_bias=None):
    out = _flash(q, k, v, key_bias)
    REC.sync("flash")
    REC.add(f"g{REC.block()} flash out", out)
    return out


def install(model):
    torch.segment_reduce = segment_reduce
    tm.qk_prep, tm.merge_kv, tm.flash_attention = qk_prep, merge_kv, flash_attention
    for kind in ("frame", "global"):
        for i, blk in enumerate(getattr(model.aggregator, f"{kind}_blocks")):
            blk.register_forward_hook(
                lambda mod, inp, out, name=f"{kind} block {i} out": REC.add(name, out))


def images(seed: int) -> torch.Tensor:
    """(1, 8, 518, 518, 3) in [0, 1]: smooth seeded noise (16x16 upsampled),
    so neighbouring patches resemble each other as in real views."""
    rng = np.random.default_rng(seed)
    low = torch.from_numpy(rng.uniform(0, 1, (8, 3, 16, 16)).astype(np.float32))
    hi = torch.nn.functional.interpolate(low, size=(518, 518), mode="bilinear",
                                         align_corners=True)
    return hi.permute(0, 2, 3, 1)[None].contiguous()


def first_difference(ref, got):
    """(index, name) of the first recorded step whose bytes differ, or None."""
    if len(ref) != len(got):
        return (-1, f"{len(ref)} steps against {len(got)}")
    for i, ((name, a), (_, b)) in enumerate(zip(ref, got)):
        if not torch.equal(a, b):
            return i, name
    return None


def outputs_equal(a, b) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a if isinstance(a[k], torch.Tensor))


def repeat_steps(ref, n: int = 20) -> None:
    """Global block 0's three steps on the reference's inputs, n times back to
    back each (no synchronization between launches), results compared."""
    steps = dict(ref)
    q, k = steps["g0 attn in q,k[0]"], steps["g0 attn in q,k[1]"]
    v = steps["g0 merge in v[0]"]
    kp, qp = steps["g0 prep out q,k[1]"], steps["g0 prep out q,k[0]"]
    km, vm, bias = (steps[f"g0 merge out k,v,bias[{i}]"] for i in range(3))
    cases = (
        ("merge_kv, checked", "checked", lambda: _merge_kv(kp, v, REC.plan)[:2]),
        ("merge_kv, unsafe", "unsafe", lambda: _merge_kv(kp, v, REC.plan)[:2]),
        ("qk_prep", "checked", lambda: _qk_prep(q, k, *REC.prep_args)),
        ("flash, key bias", "checked", lambda: (_flash(qp, km, vm, bias),)),
    )
    REC.on = False
    for name, mode, fn in cases:
        REC.mode = mode
        outs = [fn() for _ in range(n)]
        torch.cuda.synchronize()
        bad = sum(not all(torch.equal(a, b) for a, b in zip(outs[0], o)) for o in outs[1:])
        print(f"[repeat] {name}: {bad} of {n - 1} repeats differ from the first", flush=True)


def poison(pattern: str) -> None:
    """Fill every free byte of the device and of the allocator's cache with
    ``pattern`` ("nan" or "randn"): tensors of 1 GiB, then of every smaller
    power of two down to 512 bytes, as many of each as fit (so the free
    fragments of partly used segments are taken too), then free them all,
    so that the next forward's tensors start out holding the pattern."""
    blocks = []
    size = 1 << 30
    while size >= 512:
        try:
            while True:
                blocks.append(torch.empty(size // 4, device="cuda"))
        except torch.OutOfMemoryError:
            size //= 2
    for t in blocks:
        t.fill_(float("nan")) if pattern == "nan" else t.normal_()
    torch.cuda.synchronize()
    del blocks
    probe = [torch.empty(n, device="cuda") for n in (1 << 8, 1 << 18, 1 << 24)]
    held = [(t.isnan() if pattern == "nan" else t != 0).float().mean().item() for t in probe]
    print(f"[poison] {pattern}: fresh 1 KiB / 1 MiB / 64 MiB tensors hold it in "
          + " / ".join(f"{100 * h:.1f}%" for h in held) + " of their elements", flush=True)


# mode -> (merged, segment_reduce unsafe, synchronize after this step, poison)
MODE_SPECS = {
    "checked": (True, False, None, None),
    "unsafe": (True, True, None, None),
    "unsafe_sync_prep": (True, True, "prep", None),
    "unsafe_sync_merge": (True, True, "merge", None),
    "unsafe_sync_flash": (True, True, "flash", None),
    "exact": (False, False, None, None),
    "unsafe_poison_nan": (True, True, None, "nan"),
    "unsafe_poison_randn": (True, True, None, "randn"),
    "exact_poison_nan": (False, False, None, "nan"),
    "exact_poison_randn": (False, False, None, "randn"),
}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--modes", default=",".join(MODE_SPECS))
    parser.add_argument("--forwards", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("merge_determinism: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda,
          "CUDA_LAUNCH_BLOCKING=" + os.environ.get("CUDA_LAUNCH_BLOCKING", ""), flush=True)
    model = build_model(ModelConfig(), "cuda", seed=0)
    install(model)
    x = images(1).cuda()
    plan_fn = agg_mod.make_merged_attention

    def keep_plan(plan):
        REC.plan = plan
        return plan_fn(plan)

    agg_mod.make_merged_attention = keep_plan

    def forward(mode, record):
        merged, unsafe, sync, _ = MODE_SPECS[mode]
        REC.mode = ("unsafe" if unsafe else "checked") + (f"_sync_{sync}" if sync else "")
        REC.on, REC.steps = record, []
        with torch.inference_mode():
            out = model(x, global_merge_r=MERGE_R if merged else 0)
        torch.cuda.synchronize()
        REC.on = False
        return out, REC.steps

    refs = {True: forward("checked", True), False: forward("exact", True)}
    print(f"[ref] checked merged forward recorded: {len(refs[True][1])} steps; exact: "
          f"{len(refs[False][1])} steps", flush=True)
    for mode in args.modes.split(","):
        merged, _, _, pattern = MODE_SPECS[mode]
        ref_out, ref_steps = refs[merged]
        t = time.perf_counter()
        same = []
        for i in range(args.forwards):
            if pattern:
                poison(pattern)
            record = i == args.forwards - 1
            out, steps = forward(mode, record)
            same.append(outputs_equal(ref_out, out))
            if record:
                where = first_difference(ref_steps, steps)
                if where is None:
                    print(f"[{mode}] recorded forward: every step equal", flush=True)
                else:
                    i_step, name = where
                    inputs_equal = i_step > 0 and torch.equal(ref_steps[i_step - 1][1],
                                                              steps[i_step - 1][1])
                    print(f"[{mode}] recorded forward: first differing step {i_step} "
                          f"'{name}' (the step before it equal: {inputs_equal})", flush=True)
            del out, steps
        print(f"[{mode}] {args.forwards} forwards, outputs equal to the reference: {same} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
    repeat_steps(refs[True][1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
