"""Batch samplers: aspect-ratio-constrained, anchor-frame, test.

Counterpart of `iggt_official_tpu/data/samplers.py`, copied (numpy):
- `BatchedRandomSampler`: every `batch_size` consecutive indices share one
  randomly drawn aspect-ratio pool index; rank-sliced for data parallelism.
- `AnchorFrameSampler`: yields variable-length anchor groups
  ``(idx_1..idx_L, ar_idx, batch_size)`` with L drawn from the divisors of
  ``image_num_batch`` within [seq_min_len, seq_max_len] stepping by 2.
- `TestSampler`: sequential ``(idx, 0, test_batch_size)``.
"""

from __future__ import annotations

import secrets
from typing import Iterator, Tuple

import numpy as np


def round_by(total: int, multiple: int, up: bool = False) -> int:
    if up:
        total = total + multiple - 1
    return (total // multiple) * multiple


class BatchedRandomSampler:
    def __init__(self, dataset, batch_size, pool_size, world_size=1, rank=0,
                 drop_last=True):
        self.batch_size = batch_size
        self.pool_size = pool_size
        self.len_dataset = N = len(dataset)
        self.total_size = (
            round_by(N, batch_size * world_size) if drop_last else N
        )
        self.world_size = world_size
        self.rank = rank
        self.epoch = None

    def __len__(self):
        return self.total_size // self.world_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _seed(self) -> int:
        if self.epoch is None:
            assert self.world_size == 1 and self.rank == 0, (
                "use set_epoch() in distributed mode"
            )
            return secrets.randbits(32)
        return self.epoch + 777

    def __iter__(self) -> Iterator[Tuple[int, int]]:
        rng = np.random.default_rng(seed=self._seed())
        sample_idxs = np.arange(self.total_size)
        rng.shuffle(sample_idxs)

        n_batches = (self.total_size + self.batch_size - 1) // self.batch_size
        feat_idxs = rng.integers(self.pool_size, size=n_batches)
        feat_idxs = np.broadcast_to(
            feat_idxs[:, None], (n_batches, self.batch_size)
        ).ravel()[: self.total_size]

        idxs = np.c_[sample_idxs, feat_idxs]
        size_per_proc = self.batch_size * (
            (self.total_size + self.world_size * self.batch_size - 1)
            // (self.world_size * self.batch_size)
        )
        idxs = idxs[self.rank * size_per_proc : (self.rank + 1) * size_per_proc]
        yield from (tuple(int(v) for v in row) for row in idxs)


class TestSampler(BatchedRandomSampler):
    """Sequential eval sampler (`batched_sampler.py:76-88`)."""

    def __init__(self, dataset, batch_size, test_batch_size, pool_size,
                 world_size=1, rank=0, drop_last=True):
        super().__init__(dataset, batch_size, pool_size, world_size, rank,
                         drop_last)
        self.test_batch_size = test_batch_size

    def __iter__(self):
        for idx in range(self.total_size):
            yield (idx, 0, self.test_batch_size)


class AnchorFrameSampler(BatchedRandomSampler):
    """Variable-sequence-length anchor sampler (`batched_sampler.py:90-142`)."""

    def __init__(self, dataset, batch_size, seq_min_len, seq_max_len,
                 pool_size, world_size=1, rank=0, drop_last=True):
        super().__init__(dataset, 1, pool_size, world_size, rank, drop_last)
        self.image_num_batch = batch_size
        self.seq_min_len = seq_min_len
        self.seq_max_len = seq_max_len

    def __iter__(self):
        rng = np.random.default_rng(seed=self._seed())

        n_batches = self.total_size
        feat_idxs = rng.integers(self.pool_size, size=n_batches)

        if (
            self.seq_min_len == self.seq_max_len
            and self.seq_min_len == self.image_num_batch
        ):
            valid_lengths = [1]
        else:
            valid_lengths = [
                l
                for l in range(self.seq_min_len, self.seq_max_len + 1, 2)
                if self.image_num_batch % l == 0
            ]

        sample_idxs = np.arange(self.total_size)
        used = set()
        for i in range(self.total_size):
            length = int(rng.choice(valid_lengths))
            remaining = list(set(sample_idxs.tolist()) - used)
            if len(remaining) >= length:
                sampled = rng.choice(remaining, size=length, replace=False)
            else:
                sampled = rng.choice(sample_idxs, size=length, replace=True)
            used.update(int(s) for s in sampled)
            yield tuple(
                [int(s) for s in sampled]
                + [int(feat_idxs[i]), self.image_num_batch]
            )
