"""Build and load the hand-written CUDA kernels of ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded with
``ctypes``. Nothing here runs at import time: a kernel is built at its
first use, into ``repro_torch/build/`` (listed in ``.gitignore``), from the
sources in the checkout only. A library's file name carries a hash of its
source, of every ``csrc`` header it includes (``#include "x.cuh"``, followed
through the headers) and of the flags, so an edited source or header is
rebuilt and a stale library is never loaded. :func:`build` starts one
``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: every kernel source of the package (``csrc/<name>.cu``)
KERNELS = (
    "gather_rows", "segment_reduce", "flash_attention", "flash_attention_bwd",
    "embedding_bag", "scatter_rows", "segment_reduce_bwd",
)


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources(name: str):
    """``csrc/<name>.cu`` and every file of ``csrc`` it includes by a quoted
    ``#include``, followed through those files, each once, in the order
    first reached."""
    found, todo = [], [CSRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for inc in _LOCAL_INCLUDE.findall(path.read_bytes()):
            dep = path.parent / inc.decode()
            if dep.exists():
                todo.append(dep)
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built."""
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Build the named kernels that are not built yet, one ``nvcc`` process
    per source, all started together. Returns the ``ptxas -v`` report
    (registers, shared memory, spills) of each kernel built by this call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[name] = (proc, tmp, out)
    reports = {}
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
        out.with_suffix(".log").write_text(log)
        reports[name] = log
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    path = library_path(name)
    if not path.exists():
        build([name])
    return ctypes.CDLL(str(path))
