"""Build the package's native sources and load them with ctypes.

Each library is one source under ``csrc/`` with a plain C interface (no
PyTorch headers, so a build takes seconds): ``<name>.cu`` is compiled by nvcc
for Hopper (``sm_90a``), ``<name>.cpp`` (the host data decoder) by g++ with
``native/build.sh``'s flags. It is built on first use into
``tfcgan_tpu_torch/_build/``, under a name keyed on a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one is loaded as
it is. Each build writes a private file and renames it into place, so
processes that build at once (test workers) never load a half-written
library. Nothing here runs at import time: the CPU tests import every module
on machines without nvcc or a card.
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
GXX = "g++"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")  # and -pthread after the source


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _source(name: str) -> Path:
    cu = CSRC_DIR / f"{name}.cu"
    return cu if cu.exists() else CSRC_DIR / f"{name}.cpp"


def _flags(src: Path) -> tuple[str, ...]:
    return NVCC_FLAGS if src.suffix == ".cu" else (*GXX_FLAGS, "-pthread")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` (or ``.cpp``) lives for the current source."""
    src = _source(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join(_flags(src)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def _command(src: Path, out: str, nvcc: str | None) -> list[str]:
    if src.suffix == ".cu":
        return [nvcc, *NVCC_FLAGS, "-o", out, str(src)]
    return [GXX, *GXX_FLAGS, "-o", out, str(src), "-pthread"]


def build_libraries(names) -> None:
    """Compile every ``csrc/<name>`` source whose build is missing, one
    compiler each, all started together."""
    missing = [(name, library_path(name)) for name in names]
    missing = [(name, out) for name, out in missing if not out.exists()]
    if not missing:
        return
    nvcc = _nvcc() if any(_source(name).suffix == ".cu" for name, _ in missing) else None
    running, failures = [], []
    for name, out in missing:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build into a private name and rename: concurrent builders never load
        # a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        src = _source(name)
        try:
            proc = subprocess.Popen(_command(src, tmp, nvcc), stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        except OSError as e:  # no compiler
            os.unlink(tmp)
            failures.append(f"cannot run the compiler for {src.name}: {e}")
            continue
        running.append((src, out, tmp, proc))
    for src, out, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{'nvcc' if src.suffix == '.cu' else GXX} failed for "
                            f"{src.name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>`` if its build is missing, then load it."""
    build_libraries([name])
    return ctypes.CDLL(str(library_path(name)))
