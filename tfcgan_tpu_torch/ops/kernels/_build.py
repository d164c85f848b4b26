"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each library is one ``csrc/<name>.cu`` with a plain C interface (no PyTorch
headers, so a build takes seconds). It is compiled for Hopper (``sm_90a``) on
first use into ``tfcgan_tpu_torch/_build/``, under a name keyed on a hash of
the source and the flags, so an edited source is rebuilt and an unchanged one
is loaded as it is. Nothing here runs at import time: the CPU tests import
every module on machines without nvcc or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives for the current source."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build_libraries(names) -> None:
    """Compile every ``csrc/<name>.cu`` whose build is missing, one nvcc each,
    all started together."""
    missing = [(name, library_path(name)) for name in names]
    missing = [(name, out) for name, out in missing if not out.exists()]
    if not missing:
        return
    nvcc = _nvcc()
    running = []
    for name, out in missing:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build into a private name and rename: concurrent builders never load
        # a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        running.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, out, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its build is missing, then load it."""
    build_libraries([name])
    return ctypes.CDLL(str(library_path(name)))
