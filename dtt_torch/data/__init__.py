"""Data: the ImageNet VID/DET reader and roidb registry, frame transforms
(native or PIL decode), the threaded pair loader and the prefetch to the
card, the synthetic mini-VID and its renderer on the card (numpy and
torch only)."""

from dtt_torch.data.imdb import (combined_roidb, get_dataset, list_datasets,
                                 register_dataset)
from dtt_torch.data.loader import PairLoader, device_prefetch
from dtt_torch.data.synthetic import (synthetic_batch, synthetic_pair,
                                      synthetic_snippet)
from dtt_torch.data.transforms import prepare_frame, prepare_image, prepare_pair

__all__ = ["combined_roidb", "get_dataset", "list_datasets", "register_dataset",
           "PairLoader", "device_prefetch", "synthetic_batch", "synthetic_pair",
           "synthetic_snippet", "prepare_frame", "prepare_image", "prepare_pair"]
