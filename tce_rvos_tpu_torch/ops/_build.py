"""Build a CUDA source of the port (``csrc/*.cu``) into a shared library
with a plain C interface, at first use, and load it with ctypes.

Each library goes to ``build/tce_rvos_tpu_torch/`` at the root of the
checkout, named by a hash of its source, the shared headers
(``csrc/*.cuh``) and the compiler flags, so an edited source is rebuilt and
an unchanged one is reused. Nothing is compiled when a module is imported: the CPU tests import every module, and a machine
without the CUDA toolkit never calls these functions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "tce_rvos_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's kernels are built on "
            "a machine with the CUDA toolkit"
        )
    return found


def library_path(source: str) -> Path:
    """Where the library of ``csrc/<source>`` lives once built."""
    src = CSRC_DIR / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    key = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{key.hexdigest()[:16]}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` if its library is missing and return the
    library's path. The compiler's output (registers and spills, from
    ``-Xptxas -v``) is kept beside the library as ``.log``."""
    so = library_path(source)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    so.with_suffix(".log").write_text(res.stdout)
    if res.returncode != 0:
        raise RuntimeError(f"kernel build failed: {source} (nvcc exit {res.returncode}):\n"
                           f"{res.stdout}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


@functools.lru_cache(maxsize=None)
def load_library(source: str) -> ctypes.CDLL:
    """Build ``csrc/<source>`` if needed and load it (once per process)."""
    return ctypes.CDLL(str(build(source)))
