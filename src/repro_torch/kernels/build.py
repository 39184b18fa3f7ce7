"""Build and bind the port's CUDA kernels: ``nvcc`` by hand into shared
libraries with a plain C interface, loaded with ``ctypes``.

Each kernel family registers its libraries here (one per ``csrc/<name>.cu``)
when its module is imported; nothing is built then.  At first use,
``build`` starts one ``nvcc`` per missing library, all at once, into
``build/kernels/`` at the repository root (gitignored).  A library's file
name carries a hash of the flags and of every source in its ``csrc/``, so an
edit rebuilds and a repeat run reuses.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Iterable

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Library:
    """One ``csrc/<name>.cu`` and the function that declares its C entry
    points' ``argtypes``/``restype`` on the loaded library."""

    name: str
    csrc: Path
    bind: Callable[[ctypes.CDLL], ctypes.CDLL]

    def path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sorted(self.csrc.glob("*.cu*")):
            h.update(src.name.encode())
            h.update(src.read_bytes())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:16]}.so"


#: every registered library, by name (filled as kernel modules import)
LIBRARIES: dict[str, Library] = {}
#: the loaded libraries, by name — empty until a kernel is first used
LOADED: dict[str, ctypes.CDLL] = {}
#: library -> nvcc's output (the ``-Xptxas -v`` register/spill lines)
BUILD_LOG: dict[str, str] = {}
_mu = threading.Lock()


def register(lib: Library) -> Library:
    LIBRARIES[lib.name] = lib
    return lib


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    found = str(path) if path.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built from csrc/ at first use")
    return found


def build(libs: Iterable[Library] | None = None) -> dict[str, Path]:
    """Build (where missing) and load ``libs`` (default: every registered
    library); returns their paths.  The ``nvcc`` runs start together."""
    libs = list(LIBRARIES.values() if libs is None else libs)
    with _mu:
        paths = {lib.name: lib.path() for lib in libs}
        todo = [lib for lib in libs
                if lib.name not in LOADED and not paths[lib.name].exists()]
        if todo:
            nvcc = _nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            procs = {}
            for lib in todo:
                tmp = paths[lib.name].with_suffix(f".{os.getpid()}.tmp")
                procs[lib.name] = (tmp, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                     str(lib.csrc / f"{lib.name}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            failed = []
            for name, (tmp, proc) in procs.items():
                out, _ = proc.communicate()
                BUILD_LOG[name] = out
                if proc.returncode != 0:
                    failed.append(f"{name}.cu (nvcc exit {proc.returncode})"
                                  f":\n{out}")
                    tmp.unlink(missing_ok=True)
                else:
                    os.replace(tmp, paths[name])
            if failed:
                raise RuntimeError("kernel build failed: " + "\n".join(failed))
        for lib in libs:
            if lib.name not in LOADED:
                LOADED[lib.name] = lib.bind(ctypes.CDLL(str(paths[lib.name])))
        return paths


def load(lib: Library) -> ctypes.CDLL:
    """The loaded library, built first if need be."""
    loaded = LOADED.get(lib.name)
    if loaded is None:
        build([lib])
        loaded = LOADED[lib.name]
    return loaded
