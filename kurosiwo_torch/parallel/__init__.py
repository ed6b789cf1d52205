"""Multi-process runtime; counterpart of ``kurosiwo_tpu/parallel``: data
parallelism over a ("data", "model") grid of ranks, the model axis carrying
context-parallel ring attention. One process is a 1 x 1 grid, and the same
steps run unchanged."""

from .distributed import initialize, local_batch_slice, process_info
from .mesh import MeshPlan, create_mesh, shard_batch
