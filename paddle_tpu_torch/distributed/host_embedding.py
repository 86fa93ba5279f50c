"""Host-offloaded embedding tables: sparse rows live on the parameter
service, only the rows a batch touches travel to the device — the port
of ``paddle_tpu/distributed/host_embedding.py``.

Capability equivalent of the reference's sparse-remote parameter path
(SparseRemoteParameterUpdater — paddle/trainer/RemoteParameterUpdater.h:265,
sparse prefetch in TrainerInternal.cpp:119, SparseRowMatrix) for embedding
tables that exceed the card's memory: the dense model trains on the card
while the table stays host-side with server-side (e.g. adagrad) row updates.

Flow per batch:
  vecs = table.fetch(ids)            # unique-row prefetch (getParameterSparse)
  ... feed vecs as a data var (stop_gradient=False), train step fetches
      d(loss)/d(vecs) as <var>@GRAD from an Executor or ParallelExecutor ...
  table.push_grad(ids, grad_of_vecs) # row-deduped scatter-add → pserver
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..framework.scope import to_numpy
from .pserver import ParameterClient, ParameterServerService


class HostEmbedding:
    """One named table on a ParameterClient (TCP) or in-process service."""

    def __init__(self, backend: Union[ParameterClient,
                                      ParameterServerService],
                 name: str, vocab_size: int, dim: int,
                 optimizer: Optional[dict] = None,
                 init_scale: float = 0.01, seed: int = 0,
                 init: bool = True):
        self.backend = backend
        self.name = name
        self.vocab_size = vocab_size
        self.dim = dim
        if init:
            rng = np.random.RandomState(seed)
            table = (rng.randn(vocab_size, dim) * init_scale).astype(
                np.float32)
            self.backend.init_param(
                name, table, optimizer or {"type": "adagrad", "lr": 0.05})

    def fetch(self, ids: np.ndarray) -> np.ndarray:
        """Rows for (possibly repeated) ids, shape [len(ids), dim]."""
        ids = np.asarray(ids).reshape(-1)
        uniq, inverse = np.unique(ids, return_inverse=True)
        rows = self.backend.get_param_rows(self.name, uniq)
        if isinstance(rows, torch.Tensor):  # a bf16 table
            return rows[torch.as_tensor(inverse)]
        return rows[inverse]

    def push_grad(self, ids: np.ndarray, grads: np.ndarray):
        """Scatter-add grads for repeated ids, one row update per unique
        id (SelectedRows semantics: rows + dense value block)."""
        ids = np.asarray(ids).reshape(-1)
        grads = to_numpy(grads) if isinstance(grads, torch.Tensor) \
            else np.asarray(grads)
        grads = grads.astype(np.float32).reshape(len(ids), self.dim)
        uniq, inverse = np.unique(ids, return_inverse=True)
        summed = np.zeros((len(uniq), self.dim), np.float32)
        np.add.at(summed, inverse, grads)
        if isinstance(self.backend, ParameterServerService):
            self.backend.send_sparse_grad("0", self.name, uniq, summed)
        else:
            self.backend.send_sparse_grad(self.name, uniq, summed)
