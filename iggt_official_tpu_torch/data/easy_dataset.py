"""Composable dataset algebra.

Counterpart of `iggt_official_tpu/data/easy_dataset.py`, copied:
    ds1 + ds2      concatenation (SeqDataset indexing contract)
    n * ds         repeat each element n times
    n @ ds         resize to n with per-epoch shuffled mapping
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from iggt_official_tpu_torch.data.samplers import AnchorFrameSampler, TestSampler


class EasyDataset:
    """Base providing the algebra + sampler factory."""

    def __add__(self, other: "EasyDataset") -> "EasyDataset":
        return SeqDataset([self, other])

    def __rmul__(self, factor: int) -> "EasyDataset":
        return MulDataset(factor, self)

    def __rmatmul__(self, factor: int) -> "EasyDataset":
        return ResizedDataset(factor, self)

    def set_epoch(self, epoch: int) -> None:
        pass

    def make_sampler(
        self,
        batch_size: int,
        seq_min_len: int,
        seq_max_len: int,
        shuffle: bool = True,
        world_size: int = 1,
        rank: int = 0,
        drop_last: bool = True,
    ):
        pool = len(self._resolutions)
        if not shuffle:
            return TestSampler(
                self, batch_size, seq_max_len, pool,
                world_size=world_size, rank=rank, drop_last=drop_last,
            )
        return AnchorFrameSampler(
            self, batch_size, seq_min_len, seq_max_len, pool,
            world_size=world_size, rank=rank, drop_last=drop_last,
        )


class MulDataset(EasyDataset):
    """n * ds: each element repeated (`easy_dataset.py:48-74`)."""

    def __init__(self, multiplicator: int, dataset: EasyDataset):
        assert isinstance(multiplicator, int) and multiplicator > 0
        self.multiplicator = multiplicator
        self.dataset = dataset

    def __len__(self):
        return self.multiplicator * len(self.dataset)

    def __repr__(self):
        return f"{self.multiplicator}*{self.dataset!r}"

    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            idx, *other = idx
            return self.dataset[(idx // self.multiplicator, *other)]
        return self.dataset[idx // self.multiplicator]

    @property
    def _resolutions(self):
        return self.dataset._resolutions


class ResizedDataset(EasyDataset):
    """n @ ds: fixed size with per-epoch shuffle (`easy_dataset.py:77-129`)."""

    def __init__(self, new_size: int, dataset: EasyDataset):
        assert isinstance(new_size, int) and new_size > 0
        self.new_size = new_size
        self.dataset = dataset

    def __len__(self):
        return self.new_size

    def __repr__(self):
        return f"{self.new_size} @ {self.dataset!r}"

    def set_epoch(self, epoch: int) -> None:
        rng = np.random.default_rng(seed=epoch + 777)
        perm = rng.permutation(len(self.dataset))
        reps = 1 + (len(self) - 1) // len(self.dataset)
        self._idxs_mapping = np.concatenate([perm] * reps)[: self.new_size]

    def __getitem__(self, idx):
        assert hasattr(self, "_idxs_mapping"), (
            "call set_epoch() before indexing a ResizedDataset"
        )
        if isinstance(idx, tuple):
            *samples, ar_idx, batch_size = idx
            seq_num = batch_size // len(samples)
            out: List = []
            for s in samples:
                # flatten: inner datasets return a list of views per anchor
                out.extend(
                    self.dataset[(self._idxs_mapping[s], ar_idx, seq_num)]
                )
            return out
        return self.dataset[self._idxs_mapping[idx]]

    @property
    def _resolutions(self):
        return self.dataset._resolutions


class CatDataset(EasyDataset):
    """Concatenation (`easy_dataset.py:132-170`)."""

    def __init__(self, datasets: Sequence[EasyDataset]):
        for ds in datasets:
            assert isinstance(ds, EasyDataset)
        self.datasets = list(datasets)
        self._cum_sizes = np.cumsum([len(ds) for ds in datasets])

    def __len__(self):
        return int(self._cum_sizes[-1])

    def __repr__(self):
        return " + ".join(repr(ds) for ds in self.datasets)

    def set_epoch(self, epoch: int) -> None:
        for ds in self.datasets:
            ds.set_epoch(epoch)

    def _locate(self, idx: int):
        db = int(np.searchsorted(self._cum_sizes, idx, "right"))
        base = int(self._cum_sizes[db - 1]) if db > 0 else 0
        return self.datasets[db], idx - base

    def __getitem__(self, idx):
        other = None
        if isinstance(idx, tuple):
            idx, *other = idx
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        ds, new_idx = self._locate(idx)
        if other:
            return ds[(new_idx, *other)]
        return ds[new_idx]

    @property
    def _resolutions(self):
        res = self.datasets[0]._resolutions
        for ds in self.datasets[1:]:
            assert tuple(ds._resolutions) == tuple(res)
        return res


class SeqDataset(CatDataset):
    """Concatenation with the sampler's multi-anchor tuple contract
    (`easy_dataset.py:172-194`)."""

    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            raise ValueError("SeqDataset expects (idx..., ar_idx, batch_size)")
        *samples, ar_idx, batch_size = idx
        seq_num = batch_size // len(samples)
        out: List = []
        for s in samples:
            ds, new_idx = self._locate(s)
            out.extend(ds[(new_idx, ar_idx, seq_num)])
        return out
