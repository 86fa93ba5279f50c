"""Datasets, the port of ``paddle_tpu/dataset``'s ``common``,
``uci_housing``, ``mnist`` and ``conll05`` in their offline modes: a file
already in the cache (``DATA_HOME``) or a provenance-marked sliver placed
there, a legacy pickle cache, else the synthetic surrogate.  Fetching from the
network is not ported (ROADMAP.md Queue A item 3)."""

from . import common, conll05, mnist, uci_housing  # noqa: F401
