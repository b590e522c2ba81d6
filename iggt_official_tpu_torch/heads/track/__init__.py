"""CoTracker-style iterative point tracker (counterpart of
`iggt_official_tpu/heads/track/`)."""

from iggt_official_tpu_torch.heads.track.predictor import BaseTrackerPredictor
from iggt_official_tpu_torch.heads.track.track_head import TrackHead

__all__ = ["BaseTrackerPredictor", "TrackHead"]
