"""SPMD over a device mesh — the port of ``paddle_tpu/parallel/``.

``mesh`` (the Mesh of positions, the PartitionSpec mint, ``shard_map``),
``collectives`` (psum, all_gather, ppermute, all_to_all over the
positions' shards), ``sharded`` (``ShardedTensor``, ``reshard``),
``transpiler`` (``ShardingRules``, ``DistributeTranspiler``),
``parallel_executor`` (``ParallelExecutor``), ``ring_attention`` (ring,
zigzag and Ulysses attention on K4–K6), ``pipeline`` (the functional
GPipe step over ``ppermute``), ``program_pipeline``
(``ProgramPipeline``: any Program split by ``pipeline_stage`` markers),
``moe`` (the functional expert-parallel step over ``all_to_all``),
``modes`` (the eleven-mode catalog) and ``transport`` (the exchange
between processes).  One process may own every position, or the mesh may
span the processes of a ``torch.distributed`` group
(``distributed.launch.global_mesh``): each process runs the same program
on its own positions and reaches the others through the transport —
``nccl`` where every rank holds a card of its own, else ``gloo`` with card
tensors staged through pinned host buffers."""

from .mesh import make_hybrid_mesh, make_mesh  # noqa: F401
from .parallel_executor import ParallelExecutor  # noqa: F401
from .program_pipeline import ProgramPipeline  # noqa: F401
from .transpiler import DistributeTranspiler, ShardingRules  # noqa: F401
