"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file has a plain C interface. It is compiled by
``nvcc`` for ``sm_90a`` into ``build/tpu_operator_libs_torch/`` at the
root of the checkout, linked against ``libcuda`` (``-lcuda``), and
loaded with :mod:`ctypes` (:func:`load` binds its C entries'
signatures). The library name carries a hash of the source,
the shared headers (``csrc/*.cuh``), the flags and the libraries, so an
edited source is rebuilt and a built one is reused within a checkout.
:func:`build_all` starts one ``nvcc`` per source at once. Nothing here
runs when the module is imported, so the package imports on machines
without ``nvcc``; only a kernel launch needs it. The wrappers share
:func:`raise_on`, :func:`sm_count` and :func:`zeroed_counters` too.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
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
#: after the source, so the linker keeps them: libcuda, for
#: cuTensorMapEncodeTiled (TMA tensor maps)
NVCC_LIBS = ("-lcuda",)


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


def _library_path(source: str) -> Path:
    headers = b"".join(h.read_bytes()
                       for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        (CSRC_DIR / source).read_bytes() + headers
        + " ".join(NVCC_FLAGS + NVCC_LIBS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def build_all(sources) -> "list[BuiltLibrary]":
    """Compile each ``csrc/<source>`` not yet built (once per process),
    all ``nvcc`` runs in parallel, and load them, in the order given."""
    with _lock:
        running = []
        for source in dict.fromkeys(sources):
            if source in _built:
                continue
            out = _library_path(source)
            if out.exists():
                _built[source] = BuiltLibrary(ctypes.CDLL(str(out)), out,
                                              0.0, "")
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC_DIR / source), *NVCC_LIBS],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            running.append((source, out, tmp, proc, time.perf_counter()))
        failures = []
        for source, out, tmp, proc, start in running:
            _, stderr = proc.communicate()
            seconds = time.perf_counter() - start
            if proc.returncode != 0:
                failures.append(f"nvcc failed on {CSRC_DIR / source} "
                                f"(exit {proc.returncode}):\n{stderr}")
                continue
            os.replace(tmp, out)
            _built[source] = BuiltLibrary(ctypes.CDLL(str(out)), out,
                                          seconds, stderr)
        if failures:
            raise RuntimeError("\n".join(failures))
        return [_built[source] for source in sources]


def bind(lib: ctypes.CDLL, entries, error_string: str) -> ctypes.CDLL:
    """``lib`` with the argument types of its C entries (``entries``:
    name -> argtypes; each returns an int, 0 or a ``cudaError_t``) and
    of ``error_string``, its entry that gives such an error's text."""
    for name, argtypes in entries.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    fn = getattr(lib, error_string)
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


def load(source: str, entries, error_string: str) -> ctypes.CDLL:
    """``csrc/<source>`` built (at first use) and loaded, its entries
    bound as :func:`bind` says."""
    return bind(build_all([source])[0].lib, entries, error_string)


def raise_on(err: int, error_string, name: str, detail: str = "") -> None:
    """Raise if a C entry returned the CUDA error ``err`` (not 0): a
    refused launch never runs, and no synchronize would report it.
    ``error_string``: the library's entry that names the error."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed{detail}: "
                           f"{error_string(err).decode()} ({err})")


@functools.cache
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA card ``index``."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def zeroed_counters(store: dict, device, stream, size: int, who: str):
    """The ticket (or tile) counters that ``who``'s kernel takes on
    ``stream``: ``size`` int32s kept in ``store`` by (device index,
    stream), zeroed once, outside any graph capture; every launch leaves
    them 0. A capture records their address, so they live as long as the
    process."""
    import torch

    key = (device.index, stream.cuda_stream)
    counters = store.get(key)
    if counters is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{who}: the first call on a stream must not be captured "
                "(its counters are zeroed then); run one eager call on the "
                "capturing stream first")
        counters = torch.zeros(size, dtype=torch.int32, device=device)
        store[key] = counters
    return counters
