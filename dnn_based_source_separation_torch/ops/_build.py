"""Build a CUDA source of `csrc/` with nvcc and bind it with ctypes.

Each `csrc/<name>.cu` has a plain C interface. It is compiled at first use
into a shared library under `_build/` (git-ignored), keyed by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. No PyTorch headers are included: a build takes seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LIBRARIES: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time (0.0 when a cached library was loaded),
#          "log": nvcc's output, including ptxas register/shared-memory lines}
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found (looked in {candidate} and on PATH)")
    return found


def load_library(name: str) -> ctypes.CDLL:
    """Return the ctypes library built from `csrc/<name>.cu`, building it if needed.

    Raises RuntimeError with nvcc's stderr when the build fails.
    """
    lib = _LIBRARIES.get(name)
    if lib is not None:
        return lib
    source = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    target = BUILD_DIR / f"{name}-{digest}.so"
    if target.exists():
        BUILD_INFO[name] = {"seconds": 0.0, "log": "cached"}
    else:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        partial = target.with_suffix(f".{os.getpid()}.tmp")
        start = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(partial), str(source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            partial.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {source}:\n{proc.stderr}{proc.stdout}")
        os.replace(partial, target)
        BUILD_INFO[name] = {"seconds": time.perf_counter() - start,
                            "log": proc.stdout + proc.stderr}
    lib = ctypes.CDLL(str(target))
    _LIBRARIES[name] = lib
    return lib
