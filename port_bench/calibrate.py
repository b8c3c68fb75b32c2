#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card at the
cell's own size: the program's on many seeds, the control's (the
reference one precision step below the configuration's) and planted
faults' on a few. One process, one JSON line a seed.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2] [--fault-seeds 1] [--seconds 8]

Training cells: the program's first steps, the float32 reference's, the
fp8 control's, and the program fed half of each batch (the mean over
the rest). Serving cells: a short window at the cell's own load, the
int8 reference over the sample a run checks, the int4 control over the
same prompts, tokens and noise, and the program with its pick broken:
every token altered, the noise of another seed, the temperature
doubled.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from port_bench import harness  # noqa: E402
from port_bench.reference import llama_f32  # noqa: E402

harness.environment_for_run()


def half_batch(feed):
    def fed(ctx, index):
        tokens = feed(ctx, index)
        return tokens[: tokens.shape[0] // 2]
    return fed


def train_seed(ctx, driver, control: bool, fault: bool) -> dict:
    steps = ctx.cell["check_steps"]
    step, state = driver.build(ctx)
    state, program = driver.program_readings(ctx, step, state, steps)
    del state, step
    harness.free_memory(ctx.device)
    reference = driver.reference_readings(ctx, steps)
    out = {"program": llama_f32.train_gaps(program, reference)}
    if fault:
        step, state = driver.build(ctx)
        state, halved = driver.program_readings(
            ctx, step, state, steps, feed=half_batch(driver.batch))
        del state, step
        harness.free_memory(ctx.device)
        out["half_batch"] = llama_f32.train_gaps(halved, reference)
    if control:
        low = driver.reference_readings(ctx, steps,
                                        matmul=llama_f32.fp8_matmul)
        out["control"] = llama_f32.train_gaps(low, reference)
    return out


def _patch(owner, name: str, make):
    """``owner.name`` replaced by ``make(original)``; returns the undo."""
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    return lambda: setattr(owner, name, original)


def altered_token():
    """Every token the program picks moved to the next id."""
    from tpu_operator_libs_torch.examples import llama_decode

    def make(pick):
        def broken(logits_last, *args, **kwargs):
            choice, lp = pick(logits_last, *args, **kwargs)
            return (choice + 1) % logits_last.shape[-1], lp
        return broken
    return _patch(llama_decode, "_pick_next", make)


def other_noise():
    """Each request sampled from the next seed's noise, not its own."""
    from tpu_operator_libs_torch.examples.llama_serving_job import (
        DecodeServer,
    )

    def make(handle):
        def broken(self, prompt, generator=None, seed=None):
            return handle(self, prompt, seed=seed + 1)
        return broken
    return _patch(DecodeServer, "handle", make)


def doubled_temperature():
    from tpu_operator_libs_torch.examples import llama_decode

    def make(pick):
        def broken(logits_last, temperature, *args, **kwargs):
            return pick(logits_last, 2 * temperature, *args, **kwargs)
        return broken
    return _patch(llama_decode, "_pick_next", make)


SERVE_FAULTS = (altered_token, other_noise, doubled_temperature)


def serve_seed(ctx, driver, control: bool, fault: bool) -> dict:
    out = driver.run(ctx, control_bits=4 if control else None)
    result = {"program": out["gaps"], "attempted": out["attempted"],
              "failed": out["failed"], "sample": out["sample"]}
    if fault:
        for plant in SERVE_FAULTS:
            undo = plant()
            try:
                result[plant.__name__] = driver.run(ctx)["gaps"]
            finally:
                undo()
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--seconds", type=float, default=8.0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    from port_bench.run import build_kernels, context

    build_kernels()
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    faults = {int(s) for s in args.fault_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        start = time.perf_counter()
        ctx = context(args.workload, seed, args.seconds, False, "cuda",
                      start)
        driver = harness.load_module("drivers", ctx.cell["driver"])
        run = train_seed if ctx.cell["driver"] == "train" else serve_seed
        line = run(ctx, driver, seed in controls, seed in faults)
        line.update({"seed": seed, "seconds": time.perf_counter() - start})
        print(json.dumps(line), flush=True)
        harness.free_memory(ctx.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
