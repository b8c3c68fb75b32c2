"""Back-to-back training steps of ``make_train_step``, dispatched ahead.

Set-up makes the weights on the card from the seed, the optimizer's
state, and the one training step; it then drives that step through its
first ``check_steps`` steps on the window's own feed (each step a fresh
batch of uniform random ids from the seed, rows all different) and keeps
what the check compares: each step's loss, each leaf's norm of the first
clipped gradient (AdamW's first moment after one step, over 1 - b1),
and each leaf's norm of the change over those steps. The same state
goes on into the window, which dispatches steps until ``--seconds`` have
passed, keeps the losses on the card, and closes with one synchronize.

After the window the program's state is freed and the float32 reference
follows the same steps from the same weights and batches, keeping the
parameters and moments in the configuration's dtype between steps.
"""

from __future__ import annotations

import time

from port_bench import harness, trace, weights
from port_bench.reference import llama_f32


def batch(ctx, index: int):
    import torch

    shape = (ctx.traffic["batch"], ctx.traffic["seq_len"])
    return torch.randint(0, ctx.model.vocab, shape,
                         generator=weights.generator(ctx.device, ctx.seed,
                                                     "batch", index),
                         device=ctx.device, dtype=torch.int32)


def program_readings(ctx, step, state, steps: int, feed=batch):
    """Drive ``step`` through ``steps`` steps from ``state``; return the
    state after them and the numbers the check compares."""
    import torch

    names, start = zip(*llama_f32.named_leaves(state["params"]))
    losses, first_grad = [], None
    for i in range(1, steps + 1):
        state, loss = step(state, feed(ctx, i))
        losses.append(loss)
        if i == 1:
            mu = [t for _, t in llama_f32.named_leaves(state["opt"]["mu"])]
            first_grad = torch.stack([(m.float() / (1 - llama_f32.B1)).norm()
                                      for m in mu])
    now = [t for _, t in llama_f32.named_leaves(state["params"])]
    change = torch.stack([(p.float() - s.float()).norm()
                          for p, s in zip(now, start)])
    return state, {"names": list(names),
                   "losses": [x.item() for x in losses],
                   "first_grad": first_grad.tolist(),
                   "change": change.tolist()}


def build(ctx):
    """(step, state) as set-up makes them."""
    from tpu_operator_libs_torch.examples import llama

    params = weights.make_params(ctx.model, ctx.seed, ctx.device,
                                 ctx.dtype())
    optimizer, step = llama.make_train_step(ctx.model, device=ctx.device)
    return step, {"params": params, "opt": optimizer.init(params),
                  "step": 0}


def reference_readings(ctx, steps: int, matmul=None, feed=batch) -> dict:
    """The float32 reference's (or, with ``matmul``, a control's)
    readings over the same weights and batches."""
    llama_f32.no_tf32()
    params = weights.make_ends(ctx.model, ctx.seed, ctx.device, ctx.dtype())
    params = {k: v.float() for k, v in params.items()}
    params["layers"] = []
    for i in range(ctx.model.n_layers):
        layer = weights.make_layer(ctx.model, ctx.seed, i, ctx.device,
                                   ctx.dtype())
        params["layers"].append({k: v.float() for k, v in layer.items()})
        del layer
    batches = [feed(ctx, i) for i in range(1, steps + 1)]
    optim = ctx.config["optimizer"]
    out = llama_f32.train_readings(
        ctx.model, ctx.eps, params, batches, lr=ctx.model.learning_rate,
        weight_decay=optim["weight_decay"],
        clip_norm=ctx.model.grad_clip_norm,
        matmul=matmul or llama_f32.plain_matmul,
        rows_per_block=ctx.traffic["reference_rows"], storage=ctx.dtype())
    del params, batches
    harness.free_memory(ctx.device)
    return out


def run(ctx) -> dict:
    import torch

    steps = ctx.cell["check_steps"]
    rows, seq = ctx.traffic["batch"], ctx.traffic["seq_len"]
    step, state = build(ctx)
    state, program = program_readings(ctx, step, state, steps)
    harness.synchronize(ctx.device)
    setup_s = time.perf_counter() - ctx.started

    traced = profile = None
    n, losses = 0, []
    start = time.perf_counter()
    deadline = start + ctx.seconds
    while time.perf_counter() < deadline:
        if ctx.trace and n == ctx.traffic["trace_after"]:
            profile = trace.Profile(ctx.device)
            profile.start()
        with ctx.spans.span("train_step"):
            state, loss = step(state, batch(ctx, steps + 1 + n))
        losses.append(loss)
        n += 1
        if ctx.trace and n == ctx.traffic["trace_after"] \
                + ctx.traffic["trace_steps"]:
            with ctx.spans.span("synchronize"):
                ops = profile.stop()
            traced = (profile.t0, profile.t1, ops)
    if profile is not None and traced is None:
        profile.stop()  # the window closed inside the stretch: no reading
    with ctx.spans.span("synchronize"):
        harness.synchronize(ctx.device)
    window_s = time.perf_counter() - start
    failed = n - int(torch.stack(losses).isfinite().sum()) if n else 0

    device = harness.device_line(ctx.device, ctx.cell["chips"])
    del state, step
    harness.free_memory(ctx.device)

    reference = reference_readings(ctx, steps)
    gaps = llama_f32.train_gaps(program, reference)
    out = {"attempted": n, "failed": failed, "device": device,
           "gaps": gaps, "setup_s": setup_s,
           "metrics": {"train_tokens_per_s": n * rows * seq / window_s,
                       "setup_s": setup_s}}
    if traced is not None:
        t0, t1, ops = traced
        out["reading"] = trace.Reading(
            t0=t0, t1=t1, ops=trace.within(ops, t0, t1),
            spans=ctx.spans.spans, counters={},
            work={"steps": ctx.traffic["trace_steps"], "batch": rows,
                  "seq": seq},
            config=ctx.model, traffic=ctx.traffic)
    return out
