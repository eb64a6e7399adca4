"""The port's host-side native code, C++ with a plain C interface, bound
with ctypes: the FLAC decoder (``flac_decoder.cc``, :mod:`..audio.flac`)
and the batching runtime (``batch_runtime.cc``, :mod:`.batch_runtime`).

Each library is compiled with ``g++`` at first use into ``build/native/``
at the root of the checkout (listed in ``.gitignore``), its name stamped
with a hash of the source and the flags as ``ops/_build.py`` stamps the
kernels.  Each build links to a name of its own and is renamed onto the
final path, so processes that build at once never load a half-written
library.  A failed build raises.  Nothing is compiled at import time.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]


def build_library(stem: str, source: Path, build_dir: Path = BUILD_DIR
                  ) -> Path:
    """The library ``lib<stem>-<hash>.so`` of ``source`` in ``build_dir``,
    built first if it is missing."""
    src = Path(source).read_bytes()
    digest = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()
    build_dir = Path(build_dir)
    out = build_dir / f"lib{stem}-{digest[:12]}.so"
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=out.name + ".", suffix=".tmp",
                               dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {source}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
