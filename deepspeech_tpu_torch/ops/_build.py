"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/torch_kernels/lib<name>-<hash>.so``
beside the package (a directory ``.gitignore`` lists), then loaded with
``ctypes``. The file name carries a hash of the source, the headers of
``csrc/`` it includes and the flags, so an edited source or header
rebuilds and an unchanged one loads what is there. The
build runs at first use, never at import: this module imports on a
machine with no ``nvcc`` and no card.

Threads: the gateway decodes each replica on a worker thread of its
own, so two threads can reach a cold kernel together. ``build`` holds
one module lock from its check to its last rename, so the second
thread finds the library built, and writes each compile to a temp
name unique to the process and the thread, so builds from two
processes sharing ``build/`` never write one file; ``load`` holds
another while it checks, builds and loads, so one library is
loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()
_build_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the CUDA kernels build on a machine with the "
                           "CUDA toolkit")
    return path


def _target(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        text = f.read()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode())
    for header in re.findall(rb'^#include "(\w+\.cuh)"', text, re.M):
        with open(os.path.join(CSRC_DIR, header.decode()), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named sources that are not built yet, one ``nvcc``
    each, all started together. Returns ``{name: library path}``;
    raises ``RuntimeError`` with the compiler's output on a failure."""
    with _build_lock:
        return _build_locked(list(names))


def _build_locked(names) -> Dict[str, str]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for name, out in targets.items():
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = _loaded[name] = ctypes.CDLL(build([name])[name])
    return lib


def all_sources() -> list:
    """Names of every ``csrc/*.cu`` source."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))
