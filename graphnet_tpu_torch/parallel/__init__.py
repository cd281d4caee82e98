"""Training across processes, one a device (counterpart of
``graphnet_tpu/parallel``): meshes, FSDP and tensor-parallel rules, node
sharding and multi-process initialisation.  The JAX package's
``data_sharding`` and ``replicated`` name ``NamedSharding`` placements;
with one process a device and each process holding its local shard,
they have no counterpart here (a batch is sliced by ``shard_batch``)."""

from graphnet_tpu_torch.parallel.distributed import (
    host_local_batch_slice,
    init_distributed,
    shard_host_local,
)
from graphnet_tpu_torch.parallel.graph_sharding import (
    make_dp_graph_mesh,
    shard_batch_nodes,
)
from graphnet_tpu_torch.parallel.mesh import make_mesh, shard_batch
