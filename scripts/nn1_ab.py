#!/usr/bin/env python3
"""Time the `nn1` kernel of one checkout of this repository.

    python3 scripts/nn1_ab.py TREE TAG

TREE is the root of a checkout (this one, or an older commit unpacked with
`git archive` into a directory that `.gitignore` lists), TAG a label for the
output.  Needs a CUDA card.  At the three backfill shapes of the demo's
requests (every pixel of 3 views 504x336, 8 views 504x336 and 8 views
518x518 against the 150,000-point clustering subsample) it builds TREE's
`csrc/nn1.cu`, makes the same seeded clustered inputs for every tree (this
script's own generator), and prints the time of one wrapper call
(`ops/nn1.py::nn1`) from CUDA events over 3 calls after a warm-up, with a
checksum of the returned indices so that two trees' answers can be compared.
The last line is `AB <TAG> {json}`.  To compare two commits, run both in one
call on one card, in turns: parent, change, change, parent.
"""

import json
import os
import subprocess
import sys

SHAPES = {"backfill, 3 views 504x336": 3 * 504 * 336,
          "backfill, 8 views 504x336": 8 * 504 * 336,
          "backfill, 8 views 518x518": 8 * 518 * 518}
REF = 150_000


def inputs(Q: int, gen):
    """Clustered unit-scale features (6 centres plus noise), the references a
    random subset of the queries, as in the backfill."""
    import torch

    centers = torch.randn((6, 8), generator=gen, device="cuda")
    centers /= centers.norm(dim=1, keepdim=True)
    lab = torch.randint(0, 6, (Q,), generator=gen, device="cuda")
    qry = centers[lab] + 0.05 * torch.randn((Q, 8), generator=gen, device="cuda")
    ref = qry[torch.randperm(Q, generator=gen, device="cuda")[:REF]].clone()
    return qry, ref


def time_ms(fn, iters: int = 3, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(tree: str, tag: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    from iggt_official_tpu_torch.ops import cuda_build
    from iggt_official_tpu_torch.ops.nn1 import nn1

    cuda_build.build("nn1")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    out = {"device": smi}
    for label, Q in SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(0)
        qry, ref = inputs(Q, gen)
        idx = nn1(qry, ref)
        ms = time_ms(lambda: nn1(qry, ref))
        out[label] = {"ms": round(ms, 3), "index_checksum": int(idx.sum().item())}
        print(f"{tag}: {label} Q={Q} R={REF}: {ms:.3f} ms", flush=True)
        del qry, ref, idx
    print(f"AB {tag} {json.dumps(out)}", flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    main(sys.argv[1], sys.argv[2])
