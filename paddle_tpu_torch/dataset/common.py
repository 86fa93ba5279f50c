"""Dataset plumbing, the port of ``paddle_tpu/dataset/common.py``'s
offline part: ``DATA_HOME``, the per-dataset mode and provenance records,
the pickle cache readers, ``md5file``, ``synthetic_rng``, and ``local``,
which finds a dataset file already in the cache: the md5-verified
original, or a sliver of real data whose ``<file>.provenance`` sidecar
pins its checksum (``sliver-md5: <hex>``), and ``convert`` and
``recordio_task_loader``, which write a reader's samples as RecordIO
shards and read a master task's shards back.  ``download`` and ``fetch``
need a network and raise: they are not ported (ROADMAP.md Queue A item
3)."""

from __future__ import annotations

import hashlib
import os
import pickle
import sys

import numpy as np

DATA_HOME = os.environ.get(
    "PADDLE_TPU_DATA",
    os.path.join(os.path.expanduser("~"), ".cache", "paddle_tpu"),
)

# module_name -> "real" | "cache" | "synthetic": which source the last
# reader for that dataset used
DATA_MODE: dict = {}

# module_name -> the provenance text of the sliver that served as "real"
DATA_PROVENANCE: dict = {}

_NOT_PORTED = ("is not ported: the port reads datasets offline only "
               "(ROADMAP.md Queue A item 3)")


def data_mode(name: str) -> str:
    """Which source the last reader for `name` used ('real'/'cache'/
    'synthetic'; 'unused' if no reader ran yet)."""
    return DATA_MODE.get(name, "unused")


def data_provenance(name: str) -> str:
    """Where the real bytes came from ('' for the md5-verified original)."""
    return DATA_PROVENANCE.get(name, "")


def cache_path(name: str, fname: str) -> str:
    return os.path.join(DATA_HOME, name, fname)


def has_cached(name: str, fname: str) -> bool:
    return os.path.exists(cache_path(name, fname))


def load_cached(name: str, fname: str):
    with open(cache_path(name, fname), "rb") as f:
        return pickle.load(f)


def md5file(fname: str) -> str:
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url, module_name, md5sum, save_name=None, retries=3):
    raise NotImplementedError(f"dataset.common.download {_NOT_PORTED}")


def fetch(url, module_name, md5sum, save_name=None):
    raise NotImplementedError(f"dataset.common.fetch {_NOT_PORTED}")


def local(url: str, module_name: str, md5sum, save_name=None):
    """The local path of `url`'s file in DATA_HOME/<module_name>/ when it
    is the md5-verified original or a sliver whose sidecar pins its own
    checksum; else None.  A sliver whose bytes differ from its pin raises;
    one whose sidecar pins nothing is ignored unless
    PADDLE_TPU_ALLOW_FIXTURES is set."""
    fname = save_name or url.split("/")[-1]
    path = cache_path(module_name, fname)
    if not os.path.exists(path):
        return None
    if md5sum is None or md5file(path) == md5sum:
        DATA_PROVENANCE.pop(module_name, None)
        return path
    if not os.path.exists(path + ".provenance"):
        return None
    with open(path + ".provenance") as f:
        prov = f.read().strip()
    pinned = next((line.split(":", 1)[1].strip()
                   for line in prov.splitlines()
                   if line.lower().startswith("sliver-md5:")), None)
    if pinned is not None:
        if md5file(path) != pinned:
            raise IOError(
                f"{module_name}: pre-placed file {fname} does not match "
                f"its provenance sidecar checksum ({pinned})")
    elif not os.environ.get("PADDLE_TPU_ALLOW_FIXTURES"):
        print(f"[paddle_tpu_torch.dataset] {module_name}: ignoring "
              f"pre-placed {fname}: its .provenance sidecar pins no "
              "sliver-md5 (set PADDLE_TPU_ALLOW_FIXTURES=1 to accept "
              "unchecked)", file=sys.stderr)
        return None
    DATA_PROVENANCE[module_name] = prov
    return path


def synthetic_rng(name: str, seed_base: int = 0):
    """A RandomState seeded from `name` by crc32 (not ``hash()``, which is
    salted per process), so a synthetic dataset is the same in every
    process and in both packages."""
    import zlib

    return np.random.RandomState(
        (zlib.crc32(name.encode()) % (2**31)) + seed_base)


def convert(output_path, reader, line_count, name_prefix):
    """Convert a reader's samples to RecordIO shard files
    `<name_prefix>-00000`, `-00001`, ... under `output_path` — the bridge
    from any python reader to the master's chunk-task dispatch
    (reference v2/dataset/common.py:193: every dataset module exports a
    convert() built on this).  Records are pickled samples written
    through the native RecordIO writer (``native/recordio.py``), at most
    `line_count` to a shard.

    Returns the list of shard paths — pass it straight to
    MasterClient.set_dataset for chunk dispatch, and read tasks back
    with `recordio_task_loader` via distributed.master_reader."""
    from ..native import recordio as rio

    assert line_count >= 1
    os.makedirs(output_path, exist_ok=True)
    paths = []
    lines = []

    def flush():
        p = os.path.join(output_path, f"{name_prefix}-{len(paths):05d}")
        with rio.Writer(p) as w:
            for l in lines:
                w.write(pickle.dumps(l, protocol=pickle.HIGHEST_PROTOCOL))
        paths.append(p)
        lines.clear()

    for sample in reader():
        lines.append(sample)
        if len(lines) >= line_count:
            flush()
    if lines or not paths:
        flush()
    return paths


def recordio_task_loader(payload):
    """Master-task loader over convert()'s shards: payload is a shard
    path (or list of paths); yields the unpickled samples.  Plug into
    distributed.master_reader(client, recordio_task_loader)."""
    from ..native.recordio import read_records

    for path in ([payload] if isinstance(payload, str) else payload):
        for rec in read_records(path):
            yield pickle.loads(rec)
