"""Host data layer: dataset algebra, samplers, loaders, collation.

Counterpart of `iggt_official_tpu/data/` (numpy and PIL; no cv2): the
EasyDataset algebra, anchor-frame covisibility sampling, the multi-view
dataset contract, crop / rescale with intrinsics updates and covisibility
ranking, the named dataset registry (`datasets.DATASETS`), and
`get_data_loader`, a thread-prefetching iterator of numpy batches that the
training loop (`train/loop.py`) moves to the card.  Images are HWC float32
in [0, 1], the model's layout.  The 2-D mask sets (`seg2d.py`: COCO-JSON
entity masks and SAV masklets; `tsv.py`: SA-1B TSV shards) and the COLMAP
model IO (`colmap.py`) sit beside them; the converters from raw captures
to the scene layout are `iggt_official_tpu_torch/preprocess/`.
"""

from iggt_official_tpu_torch.data.base import BaseViewDataset
from iggt_official_tpu_torch.data.easy_dataset import EasyDataset
from iggt_official_tpu_torch.data.loader import collate_views, get_data_loader
from iggt_official_tpu_torch.data.ranking import compute_ranking
from iggt_official_tpu_torch.data.samplers import (
    AnchorFrameSampler,
    BatchedRandomSampler,
    TestSampler,
)
from iggt_official_tpu_torch.data.scene_dataset import SceneDirDataset

__all__ = [
    "AnchorFrameSampler",
    "BaseViewDataset",
    "BatchedRandomSampler",
    "EasyDataset",
    "SceneDirDataset",
    "TestSampler",
    "collate_views",
    "compute_ranking",
    "get_data_loader",
]
