"""Host services around the card — the port of
``paddle_tpu/distributed/``: ``pserver`` (host optimizers, the parameter
service and its TCP wire, JAX's byte for byte), ``distribute_transpiler``
(the pserver split; ``parallel.DistributeTranspiler`` is the sharding
one), ``host_embedding`` (tables on the service), ``master`` (leased task
dispatch), ``checkpoint`` (atomic, digest-verified), ``service`` and
``chaos`` (the elastic training service and its fault runner),
``launch`` (the env contract on ``torch.distributed``) and
``cluster_launch`` (``python -m paddle_tpu_torch cluster_train``)."""

from .checkpoint import (  # noqa: F401
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from .launch import init_distributed, env_trainer_count, env_trainer_id, shard_reader  # noqa: F401
from .master import (  # noqa: F401
    MasterClient,
    MasterServer,
    MasterService,
    master_reader,
)
from .service import (  # noqa: F401
    JobSpec,
    TrainingJob,
    TrainingService,
    WorkerKilled,
    prove_job_recovery,
)
from . import chaos  # noqa: F401
