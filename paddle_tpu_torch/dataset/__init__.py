"""Datasets, the port of ``paddle_tpu/dataset``: ``common`` and the
twelve readers (``cifar``, ``conll05``, ``flowers``, ``imdb``,
``imikolov``, ``mnist``, ``movielens``, ``mq2007``, ``sentiment``,
``uci_housing``, ``voc2012``, ``wmt14``) in their offline modes: a file
already in the cache (``DATA_HOME``) or a provenance-marked sliver placed
there, a legacy pickle cache, else the synthetic surrogate.  Fetching from
the network is not ported (ROADMAP.md Queue A item 3), nor is the
RecordIO ``convert`` of each module (Queue A item 12)."""

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
