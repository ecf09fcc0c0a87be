"""Build CUDA sources of ``ealv_tpu_torch/csrc`` into shared libraries and
load them with ctypes.

Each source has a plain C interface and includes no PyTorch header, so one
``nvcc`` call builds it in seconds. A library is built at first use into
``ealv_tpu_torch/_build/`` (git-ignored), named by a hash of the source and
the flags, so an edit rebuilds it and an unchanged source is loaded as is.
``build`` starts one ``nvcc`` per missing library, all at once, and waits
for every one of them. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# -Xptxas=-v reports each kernel's registers, shared memory and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# a source's own flags after those: the planner's bookkeeping kernels must
# give torch's bits, so nvcc contracts no multiply and add into an FMA there
SOURCE_FLAGS = {"descent.cu": ("--fmad=false",)}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _flags(source: str) -> tuple:
    return NVCC_FLAGS + SOURCE_FLAGS.get(source, ())


def _library_path(source: str) -> Path:
    src = (CSRC / source).read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(source)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}_{digest}.so"


def build(*sources: str) -> None:
    """Build the missing libraries of ``csrc/<source>``, one ``nvcc``
    process per source, all started together. Raises after every process
    has ended if any of them failed."""
    jobs = []
    for source in sources:
        out = _library_path(source)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(source), "-o", str(tmp), str(CSRC / source)]
        jobs.append((source, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for source, out, tmp, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {source} (rc {proc.returncode}):\n"
                          f"{stdout}\n{stderr}")
            continue
        if stderr.strip():
            print(f"[nvcc {source}] {stderr.strip()}")
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(source: str) -> ctypes.CDLL:
    """Build ``csrc/<source>`` if its library is missing, then load it."""
    if source in _loaded:
        return _loaded[source]
    build(source)
    lib = ctypes.CDLL(str(_library_path(source)))
    _loaded[source] = lib
    return lib
