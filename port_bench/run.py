#!/usr/bin/env python3
"""One run of one cell of the port's benchmark.

    python3 port_bench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

Loads the cell (``port_bench/workloads/<cell>.json``), its configuration
and traffic, and its driver; makes the weights and inputs from the seed;
warms up (``setup_s``: process start to the window's first operation);
measures for ``--seconds``; checks what the timed path produced against
the float32 reference; and prints one JSON line last on standard output.
With ``--trace 0`` its metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones, read by ``port_bench/metrics/<name>.py``
from a profiled stretch of the window. Every number compared, beside its
limit, ends the line (``checks``) and standard error.

Runs on the card only: without CUDA, or with fewer cards than the cell
asks for, it exits 2 and prints no result. It exits 3 and prints no
result if jax, flax or the JAX package was loaded.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from port_bench import harness, trace  # noqa: E402

harness.environment_for_run()


def cell_metrics(cell_name: str, kind: str) -> "list[dict]":
    """The cell's entries of ``BENCHMARK.json``'s ``end_to_end`` or
    ``per_layer``."""
    return [m for m in harness.benchmark()[kind]
            if cell_name in m.get("workloads", [cell_name])]


def context(cell_name: str, seed: int, seconds: float, trace_on: bool,
            device, started: float) -> harness.Context:
    cell = harness.load_json("workloads", cell_name)
    return harness.Context(
        cell=cell, config=harness.load_json("configs", cell["config"]),
        traffic=harness.load_json("traffic", cell["traffic"]), seed=seed,
        seconds=seconds, trace=trace_on, device=device, started=started)


def build_kernels() -> None:
    """Every CUDA source of the port built (at a checkout's first run)
    and loaded, all nvcc runs at once."""
    from tpu_operator_libs_torch import kernels
    from tpu_operator_libs_torch.kernels import _build

    _build.build_all(kernels.SOURCES)


def run_cell(cell_name: str, seed: int, seconds: float, trace_on: bool,
             device="cuda", started: float = STARTED) -> dict:
    """The result line of one run (without printing it)."""
    ctx = context(cell_name, seed, seconds, trace_on, device, started)
    if harness.on_card(device):
        build_kernels()
    return result(ctx)


def result(ctx: harness.Context) -> dict:
    """Run the cell's driver in ``ctx`` and make its result line."""
    cell_name, trace_on = ctx.cell["name"], ctx.trace
    driver = harness.load_module("drivers", ctx.cell["driver"])
    out = driver.run(ctx)
    checks = ctx.checks(out["gaps"])
    line = {"correct": harness.correct(checks),
              "attempted": out["attempted"], "failed": out["failed"]}
    device_line = out["device"]
    if not trace_on:
        line["metrics"] = {
            m["name"]: {"value": out["metrics"][m["name"]],
                        "unit": m["unit"]}
            for m in cell_metrics(cell_name, "end_to_end")
            if m["name"] in out["metrics"]}
    else:
        reading = out.get("reading")
        metrics = {}
        for m in cell_metrics(cell_name, "per_layer"):
            value = (harness.load_module("metrics", m["name"]).read(reading)
                     if reading is not None else None)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        line["metrics"] = metrics
        if reading is not None:
            device_line = {**device_line, "busy_s": trace.busy_s(reading),
                           "window_s": reading.window_s}
            line["breakdown"] = trace.breakdown(reading)
    line["device"] = device_line
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = harness.load_json("workloads", args.workload)

    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"port_bench: the cell {args.workload} needs {cell['chips']} "
              f"CUDA device(s); found {found}: no result", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"port_bench: modules that may not load were loaded: {loaded}",
              file=sys.stderr)
        return 3
    for line in harness.checks_text(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
