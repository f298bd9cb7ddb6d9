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

The C++ host decoder (``csrc/host/*.cc``: the n-gram engine and the
CTC prefix beam search of ``decode.mode="beam_fused"``) is built the
same way by ``build_host`` / ``load_host``: one ``g++`` with the JAX
package's flags, into ``build/torch_kernels/libds2host-<hash>.so``,
under the same locks, the hash taken over its sources, headers and
flags.
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

HOST_SRC_DIR = os.path.join(CSRC_DIR, "host")
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall")

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


def _host_sources():
    names = sorted(os.listdir(HOST_SRC_DIR))
    return ([os.path.join(HOST_SRC_DIR, f) for f in names
             if f.endswith(".cc")],
            [os.path.join(HOST_SRC_DIR, f) for f in names
             if f.endswith(".h")])


def build_host() -> str:
    """Compile ``csrc/host/*.cc`` with ``g++`` into one library unless
    it is built; returns its path. Raises ``RuntimeError`` with the
    compiler's output, or when there is no ``g++``."""
    sources, headers = _host_sources()
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for path in sources + headers:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    out = os.path.join(BUILD_DIR, f"libds2host-{digest.hexdigest()[:12]}.so")
    with _build_lock:
        if os.path.exists(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found on PATH; the host decoder "
                               "builds where a C++17 compiler is")
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.run(
            [gxx, *GXX_FLAGS, "-I", HOST_SRC_DIR, *sources, "-o", tmp],
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise RuntimeError(f"g++ csrc/host failed ({proc.returncode}):"
                               f"\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    return out


def load_host() -> ctypes.CDLL:
    """The loaded host decoder library, built first if needed."""
    lib = _loaded.get("host")
    if lib is None:
        with _load_lock:
            lib = _loaded.get("host")
            if lib is None:
                lib = _loaded["host"] = ctypes.CDLL(build_host())
    return lib
