"""Datasets, the port of ``paddle_tpu/dataset``: ``common`` and the
twelve readers (``cifar``, ``conll05``, ``flowers``, ``imdb``,
``imikolov``, ``mnist``, ``movielens``, ``mq2007``, ``sentiment``,
``uci_housing``, ``voc2012``, ``wmt14``) in their offline modes: a file
already in the cache (``DATA_HOME``) or a provenance-marked sliver placed
there, a legacy pickle cache, else the synthetic surrogate; nine of them
also ``convert`` their splits to RecordIO shards (``common.convert``).
Fetching from the network is not ported (ROADMAP.md Queue A item 3)."""

from . import (  # noqa: F401
    cifar,
    common,
    conll05,
    flowers,
    imdb,
    imikolov,
    mnist,
    movielens,
    mq2007,
    sentiment,
    uci_housing,
    voc2012,
    wmt14,
)
