"""Batch collation and a thread-prefetching host loader.

Counterpart of `iggt_official_tpu/data/loader.py`: `collate_views` assembles
a sampler group's views into the fixed-shape numpy batch the train step
consumes (the pose encoding through the port's
`geometry/pose_enc.py::extri_intri_to_pose_encoding`, in fp32 on the CPU),
and `get_data_loader` walks a sampler with a background-thread prefetch
queue -- numpy in, numpy out; the training loop moves each batch to the
card (`train/loop.py`).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch


def collate_views(views: List[Dict]) -> Dict[str, np.ndarray]:
    """A flat list of B*S view dicts (sampler group) -> model batch.

    The sampler yields groups whose length divides the image batch: L
    anchors x (batch/L) views each; the flat list is reshaped to
    (B=L, S=batch/L).
    """
    from iggt_official_tpu_torch.geometry.pose_enc import extri_intri_to_pose_encoding

    n = len(views)
    imgs = np.stack([v["img"] for v in views])
    H, W = imgs.shape[1:3]

    depth = np.stack([v["depthmap"] for v in views])[..., None]
    pts3d = np.stack([v["pts3d"] for v in views])
    valid = np.stack([v["valid_mask"] for v in views]).astype(np.float32)
    c2w = np.stack([v["camera_pose"] for v in views])
    K = np.stack([v["camera_intrinsics"] for v in views])

    # w2c extrinsics for the pose codec (`pose_enc.py:11-62` expects
    # cam-from-world OpenCV)
    R = c2w[:, :3, :3]
    t = c2w[:, :3, 3]
    w2c = np.concatenate(
        [np.swapaxes(R, 1, 2), -np.einsum("nji,nj->ni", R, t)[..., None]],
        axis=-1,
    )
    pose_enc = extri_intri_to_pose_encoding(
        torch.from_numpy(np.ascontiguousarray(w2c[None])),
        torch.from_numpy(np.ascontiguousarray(K[None])), (H, W)
    )[0].numpy()

    batch = {
        "images": imgs,
        "depth": depth,
        "world_points": pts3d,
        "valid_mask": valid,
        "pose_enc": pose_enc,
        "extrinsic_c2w": c2w,
        "intrinsic": K,
    }
    if all("instance_ids" in v for v in views):
        batch["instance_ids"] = np.stack([v["instance_ids"] for v in views])
    return batch


def _group_to_batch(dataset, index_tuple) -> Dict[str, np.ndarray]:
    views = dataset[index_tuple]
    L = len(index_tuple) - 2  # anchors in the tuple
    batch = collate_views(views)
    S = len(views) // L
    return {
        k: v.reshape((L, S) + v.shape[1:]) if v.ndim >= 1 else v
        for k, v in batch.items()
    }


def get_data_loader(
    dataset,
    seq_min_len: int,
    seq_max_len: int,
    batch_size: int,
    shuffle: bool = True,
    drop_last: bool = True,
    world_size: int = 1,
    rank: int = 0,
    num_prefetch: int = 2,
    epoch: Optional[int] = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Iterate model-ready batches from a dataset (or dataset expression).

    `dataset` may be an EasyDataset or a python expression string over the
    registered dataset classes (`datasets/__init__.py:42-44` semantics).
    """
    if isinstance(dataset, str):
        import iggt_official_tpu_torch.data.datasets as ds_mod

        dataset = eval(dataset, vars(ds_mod))  # noqa: S307 (config expr)

    if epoch is not None:
        dataset.set_epoch(epoch)
    sampler = dataset.make_sampler(
        batch_size, seq_min_len, seq_max_len, shuffle=shuffle,
        world_size=world_size, rank=rank, drop_last=drop_last,
    )
    if epoch is not None:
        sampler.set_epoch(epoch)

    if num_prefetch <= 0:
        for idx in sampler:
            yield _group_to_batch(dataset, idx)
        return

    q: "queue.Queue" = queue.Queue(maxsize=num_prefetch)
    _END = object()

    def worker():
        try:
            for idx in sampler:
                q.put(_group_to_batch(dataset, idx))
        except BaseException as e:  # surface worker errors to the consumer
            q.put(e)
        finally:
            q.put(_END)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
