"""Input pipeline; counterpart of ``kurosiwo_tpu/data``: grid-index readers,
tile decode, scaling, the synthetic source, packed shards, the batched
augmentations of the train step and the prefetching host loader (numpy,
in decode processes). The engine's ``device_prefetch`` moves batches to the
card."""

from .index import GridIndex, build_records, load_grid_index
from .pipeline import Loader, prepare_loaders
