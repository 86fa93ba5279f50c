"""Static analysis over Program descs — the port of
``paddle_tpu/analysis/``: the well-formedness layer between the
transpilers that rewrite descs and the executor that runs them.

    from paddle_tpu_torch.analysis import verify_program
    report = verify_program(program, fetch_names=["mean_0.tmp_0"])
    report.raise_if_errors()

Layers:
  dataflow.py    — def-use chains, happens-before graph, live intervals,
                   the executor's state classes
  verifier.py    — the PTV rule engine (stable IDs, severities,
                   suppressions); its shape oracle runs each emitter on
                   meta tensors
  contracts.py   — verified-in/verified-out wrappers for the transpilers
  cost.py        — FLOPs/roofline model + predicted step time per chip
  memory.py      — static peak-memory estimator (remat/donation-aware)
  equivalence.py — translation validation: canonicalizer, structural/
                   abstract/differential equivalence proofs (PTV022-024),
                   the parallelism modes' plan equivalence
  sharding.py    — logical-axis rules, sharding propagation, the implied
                   collectives and their price (PTV018-021)
"""

from .dataflow import (  # noqa: F401
    dependency_graph,
    def_use,
    happens_before,
    hazards,
    state_classes,
    sub_block_indices,
    var_intervals,
)
from .verifier import (  # noqa: F401
    Finding,
    Report,
    RULES,
    VerificationError,
    verify_program,
)
from . import contracts  # noqa: F401
from . import cost  # noqa: F401
from . import memory  # noqa: F401
from . import equivalence  # noqa: F401
from . import sharding  # noqa: F401
from .equivalence import (  # noqa: F401
    EquivalenceProof,
    canonicalize,
    prove_equivalent,
    semantic_diff,
)
