#!/usr/bin/env python3
"""The readings that a tensor-parallel serving cell's limit is set from,
on its cards at its own size: for each seed a short window of the pod at
the cell's own load, the served tokens' gaps under the reference (the
widest and the mean), and the controls' on the same sample (``serve_closed_tp.run(ctx,
controls=True)``): the reference with int8 weights, with an int4 cache
and with int4 weights, each picking with the same noise; and the pod
served again with its pick broken, every token altered or each request
sampled from the next seed's noise. One JSON line a seed.

    python3 port_bench/calibrate_tp.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 8]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from port_bench import harness  # noqa: E402

harness.environment_for_run()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=8.0)
    args = parser.parse_args(argv)

    import torch

    cell = harness.load_json("workloads", args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"calibrate_tp: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 2
    from port_bench.run import build_kernels, context

    build_kernels()
    for seed in (int(s) for s in args.seeds.split(",")):
        start = time.perf_counter()
        ctx = context(args.workload, seed, args.seconds, False, "cuda",
                      start)
        driver = harness.load_module("drivers", ctx.cell["driver"])
        out = driver.run(ctx, controls=True)
        print(json.dumps({"seed": seed, **out["gaps"],
                          "attempted": out["attempted"],
                          "failed": out["failed"], "sample": out["sample"],
                          "seconds": time.perf_counter() - start}),
              flush=True)
        harness.free_memory(ctx.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
