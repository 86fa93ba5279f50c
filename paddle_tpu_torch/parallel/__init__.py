"""SPMD over a device mesh — the port of ``paddle_tpu/parallel/``.

``mesh`` (the Mesh of positions, the PartitionSpec mint, ``shard_map``),
``collectives`` (psum, all_gather, ppermute, all_to_all over the
positions' shards), ``sharded`` (``ShardedTensor``, ``reshard``),
``transpiler`` (``ShardingRules``, ``DistributeTranspiler``),
``parallel_executor`` (``ParallelExecutor``), ``ring_attention`` (ring,
zigzag and Ulysses attention on K4–K6) and ``modes`` (the eleven-mode
catalog).  The pipeline executors (``pipeline.py``,
``program_pipeline.py``) and ``moe.py`` come with the next slice
(ROADMAP.md Queue A item 11)."""

from .mesh import make_hybrid_mesh, make_mesh  # noqa: F401
from .parallel_executor import ParallelExecutor  # noqa: F401
from .transpiler import DistributeTranspiler, ShardingRules  # noqa: F401
