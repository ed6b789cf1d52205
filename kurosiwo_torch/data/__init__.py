"""Input pipeline; counterpart of ``kurosiwo_tpu/data``: grid-index readers,
tile decode, scaling, the synthetic source and the prefetching host loader
(numpy only). The engine's ``device_prefetch`` moves batches to the card."""

from .index import GridIndex, build_records, load_grid_index
from .pipeline import Loader, prepare_loaders
