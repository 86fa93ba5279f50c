"""v1 `@provider` data-provider API (reference trainer/PyDataProvider2.py).

The reference decorates a per-file sample generator with slot-type
declarations (`@provider(input_types=...)`, PyDataProvider2.py:365) and the
C++ trainer pulls batches through it.  Here the same decorated generator
feeds the executor: slot types say how python sample values become
batched feeds (dense -> [B,dim] float32, integer -> [B,1] int64, sequences
-> bucket-padded LoD tensors, sparse -> densified multi-hot, where the
reference's sparse rows fed a CPU sparse matrix).  The port of
``paddle_tpu/v1/data_provider.py``: the same slots, shuffles and batches
from the same seeds.

Typical reference-style script:

    from paddle_tpu_torch.v1.data_provider import provider, integer_value, \
        integer_value_sequence

    @provider(input_types={'word': integer_value_sequence(dict_len),
                           'label': integer_value(2)},
              should_shuffle=True)
    def process(settings, file_name):
        for line in open(file_name):
            ids, lab = parse(line)
            yield {'word': ids, 'label': lab}

then `define_py_data_sources2('train.list', 'test.list', module=m,
obj='process')` registers it and `V1Trainer(cost, batch_size).train()`
(v1/trainer.py) drives passes.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np


# ---------------------------------------------------------------------------
# slot types (reference PyDataProvider2.py dense_vector:88.. sparse_binary
# _vector, integer_value, *_sequence variants)


class InputType:
    """A slot declaration: dimension + how samples batch into a feed."""

    seq = False

    def __init__(self, dim: int):
        self.dim = int(dim)

    def __repr__(self):
        return f"{type(self).__name__}({self.dim})"

    # -- conversion -----------------------------------------------------
    def to_feed(self, samples: List):
        raise NotImplementedError


class _Dense(InputType):
    def to_feed(self, samples):
        arr = np.asarray(samples, dtype=np.float32)
        return arr.reshape(len(samples), self.dim)


class _Integer(InputType):
    def to_feed(self, samples):
        return np.asarray(samples, dtype=np.int64).reshape(-1, 1)


class _SparseBinary(InputType):
    def to_feed(self, samples):
        out = np.zeros((len(samples), self.dim), np.float32)
        for i, idxs in enumerate(samples):
            out[i, np.asarray(list(idxs), np.int64)] = 1.0
        return out


class _SparseFloat(InputType):
    def to_feed(self, samples):
        out = np.zeros((len(samples), self.dim), np.float32)
        for i, pairs in enumerate(samples):
            for j, v in pairs:
                out[i, int(j)] = float(v)
        return out


class _DenseSeq(InputType):
    seq = True

    def to_feed(self, samples):
        from ..lod import LoDTensor

        return LoDTensor.from_sequences(
            [np.asarray(s, np.float32).reshape(-1, self.dim)
             for s in samples])


class _IntegerSeq(InputType):
    seq = True

    def to_feed(self, samples):
        from ..lod import LoDTensor

        return LoDTensor.from_sequences(
            [np.asarray(s, np.int64).reshape(-1, 1) for s in samples])


def dense_vector(dim: int) -> InputType:
    return _Dense(dim)


def dense_vector_sequence(dim: int) -> InputType:
    return _DenseSeq(dim)


def integer_value(value_range: int) -> InputType:
    return _Integer(value_range)


def integer_value_sequence(value_range: int) -> InputType:
    return _IntegerSeq(value_range)


def sparse_binary_vector(dim: int) -> InputType:
    return _SparseBinary(dim)


def sparse_float_vector(dim: int) -> InputType:
    return _SparseFloat(dim)


sparse_value = sparse_float_vector  # reference alias
sparse_vector = sparse_float_vector


class CacheType:
    NO_CACHE = 0
    CACHE_PASS_IN_MEM = 1


# ---------------------------------------------------------------------------


class Settings:
    """The `settings` object handed to init_hook and the process function
    (reference PyDataProvider2 DataProvider settings): carries input_types
    plus whatever init_hook attaches."""

    def __init__(self, input_types, **kwargs):
        self.input_types = input_types
        self.__dict__.update(kwargs)


class DataProvider:
    """A decorated provider: call `.reader(file_list)` for a v2-style
    sample-generator creator, or iterate batches via `.batches()`."""

    def __init__(self, fn: Callable, input_types, should_shuffle=True,
                 pool_size=-1, init_hook: Optional[Callable] = None,
                 cache: int = CacheType.NO_CACHE, check: bool = False,
                 calc_batch_size: Optional[Callable] = None, **extra):
        self.fn = fn
        self.should_shuffle = should_shuffle
        self.pool_size = pool_size
        self.cache = cache
        self.check = check
        self.calc_batch_size = calc_batch_size
        self.settings = Settings(input_types)
        self.init_hook = init_hook
        self._extra = dict(extra)
        if init_hook is not None:
            # reference init_hook(settings, ...) may replace input_types;
            # define_py_data_sources2 re-binds with file_list + args later
            init_hook(self.settings, file_list=None, **extra)
        self._cache_store: Optional[list] = None

    def bind(self, file_list=None, args=None):
        """Re-run init_hook with the registered file list and the config's
        `args` (reference data_sources.py passes args through to the
        provider's init_hook)."""
        if self.init_hook is not None:
            kwargs = dict(self._extra)
            if isinstance(args, dict):
                kwargs.update(args)
            elif args is not None:
                kwargs["args"] = args
            self.init_hook(self.settings, file_list=file_list, **kwargs)
        self._cache_store = None
        return self

    # -- slot bookkeeping ------------------------------------------------
    def slots(self) -> List[tuple]:
        """[(name_or_index, InputType)] in declaration order."""
        it = self.settings.input_types
        if isinstance(it, dict):
            return list(it.items())
        return list(enumerate(it))

    def feed_names(self, data_layer_names: Optional[Sequence[str]] = None):
        """Feed names per slot: dict input_types use their keys (reference
        'obj name is data_layer name' convention); list input_types map
        positionally onto `data_layer_names`."""
        it = self.settings.input_types
        if isinstance(it, dict):
            return list(it.keys())
        if data_layer_names is None:
            raise ValueError(
                "list-style input_types need data_layer_names to map slots "
                "to feeds")
        return list(data_layer_names)

    # -- sample stream ---------------------------------------------------
    def _sample_stream(self, file_list: Sequence[str]):
        for fname in file_list:
            for sample in self.fn(self.settings, fname):
                if self.check:
                    self._check_sample(sample)
                yield sample

    def _check_sample(self, sample):
        slots = self.slots()
        vals = self._slot_values(sample, slots)
        for (key, typ), v in zip(slots, vals):
            if isinstance(typ, (_Dense,)) and np.asarray(v).size != typ.dim:
                raise ValueError(
                    f"slot {key!r}: expected dense dim {typ.dim}, got "
                    f"{np.asarray(v).size}")
            if isinstance(typ, _Integer) and not (
                    0 <= int(v) < typ.dim):
                raise ValueError(
                    f"slot {key!r}: integer {v} out of range "
                    f"[0, {typ.dim})")

    @staticmethod
    def _slot_values(sample, slots):
        if isinstance(sample, dict):
            return [sample[k] for k, _ in slots]
        if len(slots) == 1 and not isinstance(sample, (tuple, list)):
            return [sample]
        return list(sample)

    def reader(self, file_list: Union[str, Sequence[str]]):
        """v2-style reader creator yielding per-sample tuples in slot
        order (so `paddle_tpu_torch.reader` decorators compose)."""
        files = _resolve_file_list(file_list)
        slots = self.slots()

        def _reader():
            for sample in self._sample_stream(files):
                yield tuple(self._slot_values(sample, slots))

        return _reader

    def batches(self, file_list, batch_size: int,
                seed: Optional[int] = None,
                data_layer_names: Optional[Sequence[str]] = None):
        """Yield feed dicts of batched slot values (one training step
        each).  should_shuffle with pool_size>0 streams through a bounded
        shuffle pool (constant memory for bigger-than-RAM passes); whole
        -pass shuffle (pool_size -1) and CACHE_PASS_IN_MEM materialize."""
        files = _resolve_file_list(file_list)
        slots = self.slots()
        names = self.feed_names(data_layer_names)
        rng = random.Random(seed)

        def emit(chunk):
            return {
                name: typ.to_feed([s[j] for s in chunk])
                for j, (name, (key, typ)) in enumerate(zip(names, slots))
            }

        use_cache = self.cache == CacheType.CACHE_PASS_IN_MEM
        if self.should_shuffle and not use_cache and \
                self.pool_size and self.pool_size > 0:
            # streaming bounded-pool shuffle (the reference's double-buffer
            # pool semantics): never holds more than pool_size samples
            pool: List[tuple] = []
            batch: List[tuple] = []
            for s in self._sample_stream(files):
                pool.append(tuple(self._slot_values(s, slots)))
                if len(pool) >= self.pool_size:
                    j = rng.randrange(len(pool))
                    pool[j], pool[-1] = pool[-1], pool[j]
                    batch.append(pool.pop())
                    if len(batch) == batch_size:
                        yield emit(batch)
                        batch = []
            rng.shuffle(pool)
            for s in pool:
                batch.append(s)
                if len(batch) == batch_size:
                    yield emit(batch)
                    batch = []
            if batch and len(batch) == batch_size:
                yield emit(batch)
            return

        if use_cache and self._cache_store is not None:
            samples = list(self._cache_store)
        else:
            samples = [tuple(self._slot_values(s, slots))
                       for s in self._sample_stream(files)]
            if use_cache:
                self._cache_store = list(samples)
        if self.should_shuffle:
            rng.shuffle(samples)
        for i in range(0, len(samples), batch_size):
            chunk = samples[i:i + batch_size]
            if len(chunk) < batch_size and i > 0:
                break  # drop ragged tail (static-shape executor batches)
            yield emit(chunk)


def provider(input_types=None, should_shuffle=True, pool_size=-1,
             min_pool_size=-1, can_over_batch_size=True, calc_batch_size=None,
             cache=CacheType.NO_CACHE, check=False, check_fail_continue=False,
             init_hook=None, **outter_kwargs):
    """The decorator (reference PyDataProvider2.py:365 signature kept for
    drop-in config compatibility; pool/overbatch knobs that only tuned the
    C++ double-buffer are accepted and where meaningful honored)."""
    if input_types is None:
        raise ValueError("@provider needs input_types")

    def deco(fn):
        return DataProvider(fn, input_types, should_shuffle=should_shuffle,
                            pool_size=pool_size, init_hook=init_hook,
                            cache=cache, check=check,
                            calc_batch_size=calc_batch_size, **outter_kwargs)

    return deco


# ---------------------------------------------------------------------------
# config-side registration (reference trainer_config_helpers/data_sources.py
# define_py_data_sources2)

_data_sources: Dict[str, DataProvider] = {}
_data_files: Dict[str, List[str]] = {}


def _resolve_file_list(file_list) -> List[str]:
    """A .list file (one path per line), a single path, or a sequence."""
    if isinstance(file_list, str):
        if file_list.endswith(".list"):
            with open(file_list) as f:
                return [ln.strip() for ln in f if ln.strip()]
        return [file_list]
    return list(file_list)


def define_py_data_sources2(train_list, test_list, module, obj, args=None):
    """Register train/test providers (reference data_sources.py:59).

    `module` is a python module (or import path) whose attribute `obj` is
    the @provider-decorated function; `args` reaches the provider's
    init_hook (reference data_sources.py behavior) via `bind()`."""
    import importlib

    if isinstance(module, str):
        module = importlib.import_module(module)
    prov = getattr(module, obj)
    if not isinstance(prov, DataProvider):
        raise TypeError(f"{obj!r} is not an @provider-decorated function")
    if train_list is not None:
        files = _resolve_file_list(train_list)
        prov.bind(file_list=files, args=args)
        _data_sources["train"] = prov
        _data_files["train"] = files
    if test_list is not None:
        files = _resolve_file_list(test_list)
        if train_list is None:
            prov.bind(file_list=files, args=args)
        _data_sources["test"] = prov
        _data_files["test"] = files
    return prov


def get_data_source(kind: str = "train"):
    return _data_sources.get(kind), _data_files.get(kind)


def reset_data_sources():
    _data_sources.clear()
    _data_files.clear()
