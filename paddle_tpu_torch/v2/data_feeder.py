"""v2 DataFeeder, the port of ``paddle_tpu/v2/data_feeder.py`` (reference
python/paddle/v2/data_feeder.py:28 —
DataFeeder(data_types, feeding) over DataProviderConverter): converts a
minibatch of sample tuples into the executor feed dict.  `feeding` maps
var name -> tuple position and may reference a SUBSET of the sample
columns at arbitrary (non-contiguous) positions — samples can carry
extra columns the graph never reads, a documented reference use case.
Thin projection over the fluid DataFeeder, which knows each data var's
dtype/shape/sequence layout from the program.  The v2 trainer shares
this class so the feeding-map semantics cannot fork."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class ProjectingFeeder:
    """feed(minibatch) for ordered (name, position) pairs: projects each
    sample tuple down to the fed columns, then delegates layout
    conversion to the fluid DataFeeder."""

    def __init__(self, pairs: Sequence[Tuple[str, int]], program=None):
        self.pairs = list(pairs)
        self._program = program
        self._impl = None

    def _feeder(self):
        if self._impl is None:
            from ..data_feeder import DataFeeder as FluidFeeder
            from ..framework.core import default_main_program

            self._impl = FluidFeeder(
                feed_list=[n for n, _ in self.pairs],
                program=(self._program if self._program is not None
                         else default_main_program()))
        return self._impl

    def feed(self, dat):
        positions = [p for _, p in self.pairs]
        if positions != list(range(len(positions))):
            dat = [tuple(sample[p] for p in positions) for sample in dat]
        return self._feeder().feed(dat)


def pairs_from_feeding(feeding: Dict[str, int]) -> List[Tuple[str, int]]:
    """(name, position) pairs ordered by position — the feed-column
    projection order."""
    return sorted(feeding.items(), key=lambda kv: kv[1])


class DataFeeder(ProjectingFeeder):
    def __init__(self, data_types: Sequence[Tuple[str, object]],
                 feeding: Optional[Dict[str, int]] = None, program=None):
        self.data_types = list(data_types)
        names = [n for n, _ in self.data_types]
        if feeding is None:
            feeding = {n: i for i, n in enumerate(names)}
        self.feeding = dict(feeding)
        super().__init__(
            [(n, p) for n, p in pairs_from_feeding(self.feeding)
             if n in set(names)], program=program)

    def convert(self, dat, argument=None):
        """Minibatch of sample tuples -> executor feed dict."""
        return self.feed(dat)

    __call__ = convert
