"""What every cell's run shares: its files, its seeds' streams, the
harness's own spans, the device line and the result line.

A cell is ``workloads/<cell>.json``: the configuration it runs
(``configs/<config>.json``), its traffic (``traffic/<traffic>.json``),
the driver that runs it (``drivers/<driver>.py``), the limits of its
output check and why it exists. A per-layer metric is
``metrics/<metric>.py``, whose ``read(reading)`` returns a number or
None. Everything is found by the names in ``BENCHMARK.json``, so a new
cell, configuration, traffic mix or metric is new files and entries,
never an edit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
#: top-level module names that may never be loaded in a run
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tpu_operator_libs")


def cache_dirs() -> dict:
    """Fixed build and kernel-cache directories inside the checkout."""
    base = CHECKOUT / "build" / "port_bench"
    return {"TRITON_CACHE_DIR": str(base / "triton"),
            "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions")}


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"port_bench_{kind}_{name.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark() -> dict:
    with open(CHECKOUT / "BENCHMARK.json") as f:
        return json.load(f)


def llama_config(config: dict):
    """The port's ``LlamaConfig`` from a configuration file's ``model``
    group."""
    from tpu_operator_libs_torch.examples.llama import LlamaConfig

    return LlamaConfig(**config["model"])


class Spans:
    """The harness's own spans around its calls into the program:
    (name, start ns, end ns) on the wall clock the profiler's events
    carry, from any thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self.spans: "list[tuple[str, int, int]]" = []

    def add(self, name: str, start: int, end: int) -> None:
        with self._lock:
            self.spans.append((name, start, end))

    def span(self, name: str):
        return _Span(self, name)


class _Span:
    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.time_ns()
        self.spans.add(self.name, self.start, self.end)
        return False


def on_card(device) -> bool:
    return str(device).startswith("cuda")


def synchronize(device) -> None:
    """Wait for the card (nothing to wait for on the CPU, where the tests
    drive a run)."""
    import torch

    if on_card(device):
        torch.cuda.synchronize()


def free_memory(device) -> None:
    import gc

    import torch

    gc.collect()
    if on_card(device):
        torch.cuda.empty_cache()


def device_line(device, count: int) -> dict:
    """The result's ``device``; on the CPU (a test's run) it says so."""
    import torch

    if not on_card(device):
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(count))}


def forbidden_loaded() -> "list[str]":
    """Loaded modules whose top-level name is a forbidden one, compared
    whole: ``tpu_operator_libs_torch`` is not ``tpu_operator_libs``."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN_MODULES})


def checks_text(checks: dict) -> "list[str]":
    return [f"check {name}: {c['value']!r} limit {c['limit']!r}"
            for name, c in checks.items()]


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks, over all values."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("no values")
    pos = (len(ordered) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(ordered) - 1)
    return ordered[lo] + (ordered[hi] - ordered[lo]) * (pos - lo)


def environment_for_run() -> None:
    """Cache directories inside the checkout, set before torch loads."""
    for key, value in cache_dirs().items():
        os.environ[key] = value
        Path(value).mkdir(parents=True, exist_ok=True)


class Context:
    """One run as a driver sees it: the seed, the window's seconds,
    whether to trace, the device, the model (the port's ``LlamaConfig``)
    and its configuration file, the traffic, the cell, the spans, and
    the perf_counter reading at which the process started."""

    def __init__(self, *, cell: dict, config: dict, traffic: dict,
                 seed: int, seconds: float, trace: bool, device,
                 started: float):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.started = device, started
        self.model = llama_config(config)
        self.spans = Spans()

    @property
    def eps(self) -> float:
        return self.config["rms_norm_eps"]

    @property
    def limits(self) -> dict:
        return self.cell["limits"]

    def dtype(self):
        import torch

        return getattr(torch, self.config["precision"]["params"])

    def checks(self, values: dict) -> dict:
        """Each compared number beside its limit."""
        return {name: {"value": values[name], "limit": limit}
                for name, limit in self.limits.items()}


def correct(checks: dict) -> bool:
    import math

    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())
