"""SPMD over a device mesh — the port of ``paddle_tpu/parallel/``.

``mesh`` (the Mesh of positions, the PartitionSpec mint, ``shard_map``),
``collectives`` (psum, all_gather, ppermute, all_to_all over the
positions' shards), ``sharded`` (``ShardedTensor``, ``reshard``),
``transpiler`` (``ShardingRules``, ``DistributeTranspiler``),
``parallel_executor`` (``ParallelExecutor``), ``ring_attention`` (ring,
zigzag and Ulysses attention on K4–K6), ``pipeline`` (the functional
GPipe step over ``ppermute``), ``program_pipeline``
(``ProgramPipeline``: any Program split by ``pipeline_stage`` markers),
``moe`` (the functional expert-parallel step over ``all_to_all``) and
``modes`` (the eleven-mode catalog).  The mesh is single-controller: a
mesh over several processes is ROADMAP.md Queue A item 11's one item
left."""

from .mesh import make_hybrid_mesh, make_mesh  # noqa: F401
from .parallel_executor import ParallelExecutor  # noqa: F401
from .program_pipeline import ProgramPipeline  # noqa: F401
from .transpiler import DistributeTranspiler, ShardingRules  # noqa: F401
