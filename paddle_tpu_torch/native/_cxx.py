"""The native libraries' build: each compiles with ``g++`` at first use into
``paddle_tpu_torch/_build/``, under a name that carries a hash of its
sources and its compile command, so an edited source or another compiler
builds anew, and is published by an atomic rename, so a reader never opens
a half-written file.  A failed build raises with the compiler's output;
nothing is ever built beside its source."""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from typing import List, Sequence

BUILD = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")


def hashed_path(build: str, stem: str, command: Sequence[str],
                sources: Sequence[str], suffix: str = ".so") -> str:
    """``<build>/<stem>_<hash><suffix>``, the hash over the command and
    the sources' bytes."""
    h = hashlib.sha256(" ".join(command).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(build, f"{stem}_{h.hexdigest()[:16]}{suffix}")


def compile_to(tag: str, cxx: str, src: str, out: str, flags: List[str],
               libs: Sequence[str] = ()) -> str:
    """``cxx flags -o out src libs`` into a temporary file beside `out`,
    published by ``os.replace``; raises with the compiler's output."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=os.path.dirname(out))
    os.close(fd)
    try:
        try:
            r = subprocess.run([cxx, *flags, "-o", tmp, src, *libs],
                               capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"{tag}: cannot run {cxx!r}: {e}") from e
        if r.returncode:
            raise RuntimeError(f"{tag}: {cxx} failed on {src}:\n"
                               f"{r.stdout}{r.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
