"""Multi-process runtime; counterpart of ``kurosiwo_tpu/parallel``: data
parallelism over a ("data", "model") grid of ranks, the model axis carrying
tensor parallelism (``sharding.py``: JAX's rule, the layers on their
slices) or context-parallel ring attention. One process is a 1 x 1 grid,
and the same steps run unchanged. ``python -m kurosiwo_torch.parallel.dryrun
--ranks N`` runs the DP x TP dry run on CPU Gloo ranks."""

from .distributed import initialize, local_batch_slice, process_info
from .mesh import MeshPlan, create_mesh, shard_batch
