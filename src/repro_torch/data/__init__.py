"""Data pipeline: deterministic synthetic datasets (nothing is downloaded)
with sharded host loading and prefetch onto the card or a mesh's slots
(the counterpart of ``repro.data``)."""
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.synthetic import (
    SyntheticImageDataset,
    TokenStreamConfig,
    make_image_dataset,
    synthetic_token_batches,
)

__all__ = [
    "SyntheticImageDataset",
    "make_image_dataset",
    "synthetic_token_batches",
    "TokenStreamConfig",
    "ShardedLoader",
]
