#!/usr/bin/env python3
"""Time the bucket top-k kernel of one checkout of this repository.

    python3 scripts/bucket_ab.py TREE TAG

TREE is the root of a checkout (this one, or an older commit unpacked with
`git archive` into a directory that `.gitignore` lists), TAG a label for the
output.  Needs a CUDA card.  At the clustering subsample's size (Q = R =
150,000 8-D features, nb = 1024, k = 64) it builds TREE's `csrc/nn1.cu` and
takes two inputs: clustered features made by this script's own seeded
generator, and the subsample the clustering draws from the smoothed
features of `chip_smoke.py`'s 10-view Voronoi scene (the postproc phase's
bucket top-k path; smoothing leaves many near ties).  For each it prints
the time of the bucket minima kernel (`ops/nn1.py::bucket_minima_kernel`)
and of the whole wrapper (`bucket_topk`: kernel and stable sort) from CUDA
events over 3 calls after a warm-up, with a checksum of the returned
bucket-minimum indices so that two trees' answers can be compared.  The last line is `AB <TAG> {json}`.  To
compare two commits, run both in one call on one card, in turns: parent,
change, change, parent.
"""

import json
import os
import sys

Q = 150_000
NB = 1024
K = 64


def inputs(gen):
    """Clustered features: 6 unit centres in 8-D plus noise 0.05."""
    import torch

    centers = torch.randn((6, 8), generator=gen, device="cuda")
    centers /= centers.norm(dim=1, keepdim=True)
    lab = torch.randint(0, 6, (Q,), generator=gen, device="cuda")
    return centers[lab] + 0.05 * torch.randn((Q, 8), generator=gen, device="cuda")


def main(tree: str, tag: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke
    from iggt_official_tpu_torch.ops import cuda_build
    from iggt_official_tpu_torch.ops import nn1 as nn1_mod

    cuda_build.build("nn1")
    from iggt_official_tpu_torch.ops.cluster import BUDGET, _subsample
    from iggt_official_tpu_torch.ops.knn import knn_smooth_features

    pts, fts = chip_smoke.voronoi_scene(*chip_smoke.PP_SCENE, seed=1)
    smoothed = knn_smooth_features(torch.from_numpy(pts).cuda(), torch.from_numpy(fts).cuda(),
                                   k=20).reshape(-1, 8)
    rows, _, _ = _subsample(smoothed.shape[0], BUDGET, 100, 500)
    cases = {"clustered": inputs(torch.Generator(device="cuda").manual_seed(0)),
             "smoothed scene subsample": smoothed[torch.as_tensor(rows, device="cuda")]
             .contiguous()}
    del pts, fts, smoothed
    out = {}
    for name, x in cases.items():
        _, bi = nn1_mod.bucket_minima_kernel(x, x, NB)
        out[name] = {
            "kernel ms": round(chip_smoke.time_ms(
                lambda: nn1_mod.bucket_minima_kernel(x, x, NB), iters=3, warmup=1), 3),
            "wrapper ms": round(chip_smoke.time_ms(
                lambda: nn1_mod.bucket_topk(x, x, K, NB), iters=3, warmup=1), 3),
            "index checksum": int((bi.double() * torch.arange(NB, device="cuda")).sum().item()),
        }
    print(f"AB {tag} " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
