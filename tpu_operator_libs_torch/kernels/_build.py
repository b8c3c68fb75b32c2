"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file has a plain C interface. It is compiled by
``nvcc`` for ``sm_90a`` into ``build/tpu_operator_libs_torch/`` at the
root of the checkout and loaded with :mod:`ctypes`. The library name
carries a hash of the source and the flags, so an edited source is
rebuilt and a built one is reused within a checkout. Nothing here runs
when the module is imported, so the package imports on machines without
``nvcc``; only a kernel launch needs it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" \
    / "tpu_operator_libs_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuiltLibrary:
    """A loaded kernel library and what its build reported."""

    lib: ctypes.CDLL
    path: Path
    #: wall seconds of the nvcc run (0.0 when an earlier build was reused)
    build_seconds: float
    #: ptxas' register / shared-memory / spill report ("" when reused)
    ptxas_report: str


_lock = threading.Lock()
_built: "dict[str, BuiltLibrary]" = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found under {cuda_home}/bin or on PATH: the CUDA "
            "kernels are built from source at first use")
    return found


def build(source: str) -> BuiltLibrary:
    """Compile ``csrc/<source>`` (once per process) and load it."""
    with _lock:
        if source in _built:
            return _built[source]
        src = CSRC_DIR / source
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
        out = BUILD_DIR / f"{src.stem}-{digest[:16]}.so"
        seconds, report = 0.0, ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            start = time.perf_counter()
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True, check=False)
            seconds = time.perf_counter() - start
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src} (exit {proc.returncode}):\n"
                    f"{proc.stderr}")
            os.replace(tmp, out)
            report = proc.stderr
        built = BuiltLibrary(ctypes.CDLL(str(out)), out, seconds, report)
        _built[source] = built
        return built
