#!/usr/bin/env python3
"""Resumable PyTorch training job: the workload the checkpoint gate
protects.

Mirrors ``tpu_operator_libs/examples/jax_training_job.py``: ``init_state``
(the dp x tp MLP + Adam), ``make_batch``, ``make_checkpoint_manager``,
``restore_state``, ``init_state_llama``, ``train`` and ``main``. One
device trains in this process; ``--n-devices n`` starts n ranks
(``parallel.run_ranks``: NCCL on n cards, gloo on the CPU) over the
reference's dp x tp mesh. Orbax becomes :class:`CheckpointManager`, a
small copy of Orbax's contract over ``torch.distributed.checkpoint``
(DCP). During a rolling upgrade the
operator parks a node until this job's newest checkpoint is durable
(:class:`~tpu_operator_libs_torch.health.checkpoint_gate.CheckpointDurabilityGate`),
evicts the pod, and a replacement resumes from that checkpoint: the
worst-case loss is the steps since the last commit. Run it on the card:

    python -m tpu_operator_libs_torch.examples.training_job \\
        --checkpoint-dir ckpt --max-steps 200 --save-interval 20

Kill it at any point and rerun: it continues from the last committed
step. On two cards: add ``--n-devices 2``; on the CPU, ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging
import os
import shutil
import signal
import sys
import threading
import warnings
from typing import Optional

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from tpu_operator_libs_torch import resolve_device
from tpu_operator_libs_torch.convert import shard_params
from tpu_operator_libs_torch.examples.llama import (
    config_for_mesh,
    init_llama_params,
    make_token_batch,
    make_train_step,
)
from tpu_operator_libs_torch.health.checkpoint_gate import committed_steps
from tpu_operator_libs_torch.optim import AdamW, tree_map, value_and_grad
from tpu_operator_libs_torch.parallel import (
    TP_SPLIT_DIM,
    any_rank,
    copy_to_tp,
    local_rows,
    mean_over_dp,
    reduce_from_tp,
    run_ranks,
    spawn_context,
    tp_of,
)

logger = logging.getLogger("torch-training-job")


def init_state(device, d_in: int = 32, d_hidden_per_shard: int = 16,
               learning_rate: float = 1e-2, *, mesh=None):
    """(state, apply_update) for the tiny regression MLP with Adam;
    state is ``{"params", "opt", "step"}`` on ``device``. The hidden
    width is ``d_hidden_per_shard * tp``: with a ``mesh`` ``w1``'s
    columns and ``w2``'s rows split over tp (the activations are summed
    over tp) and the gradients are averaged over dp."""
    device = mesh.device if mesh is not None else resolve_device(device)
    d_hidden = d_hidden_per_shard * tp_of(mesh)
    gen = torch.Generator().manual_seed(0)
    params = shard_params({
        "w1": (torch.randn((d_in, d_hidden), generator=gen) * 0.1).to(device),
        "w2": (torch.randn((d_hidden, 1), generator=gen) * 0.1).to(device),
    }, mesh)
    optimizer = AdamW(learning_rate, weight_decay=0.0)  # optax.adam
    state = {"params": params, "opt": optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}

    def loss_fn(params, batch_x, batch_y):
        hidden = torch.tanh(copy_to_tp(batch_x, mesh) @ params["w1"])
        pred = reduce_from_tp(hidden @ params["w2"], mesh)
        return torch.mean((pred - batch_y) ** 2)

    def apply_update(state, batch_x, batch_y):
        loss, grads = value_and_grad(loss_fn, state["params"], batch_x,
                                     batch_y)
        if mesh is not None:
            loss = mean_over_dp(loss, mesh)
            grads = tree_map(lambda g: mean_over_dp(g, mesh), grads)
        params, opt = optimizer.update(grads, state["opt"], state["params"])
        return {"params": params, "opt": opt,
                "step": state["step"] + 1}, loss

    return state, apply_update


def make_batch(step: int, batch_per_shard: int = 8, d_in: int = 32, *,
               device=None, mesh=None):
    """Deterministic synthetic regression batch of ``batch_per_shard *
    dp`` rows (a CPU generator seeded ``1000 + step``, so every device
    sees the same numbers); with a ``mesh``, this rank's dp block."""
    gen = torch.Generator().manual_seed(1000 + step)
    batch = batch_per_shard * (mesh.dp if mesh is not None else 1)
    x = torch.randn((batch, d_in), generator=gen)
    y = torch.sum(x[:, :4], dim=1, keepdim=True)  # learnable target
    device = mesh.device if mesh is not None else resolve_device(device)
    return local_rows(x, mesh).to(device), local_rows(y, mesh).to(device)


@contextlib.contextmanager
def _single_process():
    """Silence DCP's notice that it runs in one process: one process is
    this job's layout, asked for with ``no_dist=True``."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is "
                                "disabled", category=UserWarning)
        yield


def _dcp_keys(state, mesh):
    """The state as DCP sees it. DCP takes plain tensors that share a
    key across ranks for replicas and writes one rank's copy, which would
    keep one tp shard and drop the others; so at tp > 1 each tp-sharded
    leaf's key names its shard (``wq@tp1``). The leaves are ``state``'s
    own tensors, so a load fills ``state`` in place. Replicated leaves
    keep their keys, and the dp replicas of a shard share its key."""
    if tp_of(mesh) == 1:
        return state

    def walk(node):
        if isinstance(node, dict):
            return {(f"{k}@tp{mesh.tp_rank}" if k in TP_SPLIT_DIM else k):
                    walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return node

    return walk(state)


class CheckpointManager:
    """Orbax ``CheckpointManager``'s contract over DCP: step ``n`` is
    saved to ``<directory>/<n>/``; a save returns only once the step is
    committed (DCP renames its ``.metadata`` into place last, which is
    what the checkpoint gate reads); the oldest committed steps beyond
    ``max_to_keep`` are removed after each save. With a ``mesh`` every
    rank calls :meth:`save` and :meth:`restore` together, each with its
    own shards (:func:`_dcp_keys`), and rank 0 prunes."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> "list[int]":
        return committed_steps(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, mesh=None) -> None:
        if step in self.all_steps():
            raise ValueError(f"step {step} is already committed in "
                             f"{self.directory}")
        with _single_process():
            dcp.save(_dcp_keys(state, mesh),
                     checkpoint_id=os.path.join(self.directory, str(step)),
                     no_dist=mesh is None)
        if mesh is None or dist.get_rank() == 0:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, step: int, state, mesh=None):
        """Load step ``step`` into ``state``'s tensors, in place (they
        give the shapes, dtypes and devices), and return ``state``."""
        with _single_process():
            dcp.load(_dcp_keys(state, mesh),
                     checkpoint_id=os.path.join(self.directory, str(step)),
                     no_dist=mesh is None)
        return state


def make_checkpoint_manager(checkpoint_dir: str,
                            max_to_keep: int = 3) -> CheckpointManager:
    return CheckpointManager(checkpoint_dir, max_to_keep=max_to_keep)


def restore_state(manager: CheckpointManager, state, mesh=None):
    """Resume from the newest committed step, or return ``state`` as-is.
    Returns (state, start_step); restored tensors land on the devices of
    ``state``'s."""
    latest = manager.latest_step()
    if latest is None:
        return state, 0
    manager.restore(latest, state, mesh)
    logger.info("resumed from checkpoint step %d", latest)
    return state, latest


def init_state_llama(device, trainer_overrides=None, *, mesh=None):
    """(state, step_fn, config) for the Llama-style decoder, with the
    MLP's state contract, on one device or on this rank's shards of a
    ``mesh``. ``trainer_overrides`` replaces LlamaConfig fields (the
    schedule and clip knobs); a checkpoint must resume with the same
    overrides."""
    config = config_for_mesh(tp_of(mesh))
    if trainer_overrides:
        config = dataclasses.replace(config, **trainer_overrides)
    device = mesh.device if mesh is not None else resolve_device(device)
    params = init_llama_params(config, device=device, mesh=mesh)
    optimizer, step_fn = make_train_step(config, device=device, mesh=mesh)
    state = {"params": params, "opt": optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    return state, step_fn, config


def _workload(model, device, trainer_overrides, mesh):
    """(state, apply_update, next_batch) of ``model`` on ``device`` or
    on this rank's part of ``mesh``."""
    if model == "llama":
        state, step_fn, config = init_state_llama(device, trainer_overrides,
                                                  mesh=mesh)

        def apply_update(state, x, y):
            return step_fn(state, x)

        def next_batch(step):
            return make_token_batch(step, config, device=device,
                                    mesh=mesh), None

        return state, apply_update, next_batch
    state, apply_update = init_state(device, mesh=mesh)
    return state, apply_update, lambda step: make_batch(step, device=device,
                                                        mesh=mesh)


def _train_loop(checkpoint_dir, max_steps, save_interval, model,
                trainer_overrides, device, stop_flag, mesh=None) -> dict:
    state, apply_update, next_batch = _workload(model, device,
                                                trainer_overrides, mesh)
    manager = make_checkpoint_manager(checkpoint_dir)
    state, start_step = restore_state(manager, state, mesh)
    loss = None
    step = start_step
    for step in range(start_step, max_steps):
        if any_rank(stop_flag is not None and stop_flag(), mesh):
            logger.info("stop requested at step %d", step)
            break
        x, y = next_batch(step)
        state, loss = apply_update(state, x, y)
        done = step + 1
        if done % save_interval == 0 or done == max_steps:
            # blocking save: once save() returns the step is committed,
            # which is exactly what the operator's gate checks for
            manager.save(done, state, mesh)
            logger.info("step %d: loss %.5f (checkpoint committed)", done,
                        float(loss))
        step = done
    return {"final_step": step, "start_step": start_step,
            "loss": None if loss is None else float(loss)}


def train_rank(mesh, checkpoint_dir, max_steps, save_interval, model,
               trainer_overrides, stop) -> dict:
    """One rank of a multi-device run (``run_ranks`` starts it); ``stop``
    is an event the parent sets, and every rank stops at the same step."""
    return _train_loop(checkpoint_dir, max_steps, save_interval, model,
                       trainer_overrides, mesh.device, stop.is_set, mesh)


def train(checkpoint_dir: str, max_steps: int = 100,
          save_interval: int = 10, device=None, stop_flag=None,
          model: str = "mlp", trainer_overrides=None,
          n_devices: Optional[int] = None) -> dict:
    """The training loop. Returns {"final_step", "start_step", "loss"}.

    ``model`` picks the workload: "mlp" (tiny regression net) or "llama"
    (the Llama-style decoder); ``trainer_overrides`` (llama only)
    replaces LlamaConfig fields. ``n_devices`` > 1 trains on that many
    ranks over the dp x tp mesh (``parallel.dp_tp_split``) and returns
    rank 0's result; ``stop_flag`` is then polled here and passed on.
    ``n_devices=None`` takes every visible card, as the reference's
    ``make_mesh(None)`` takes every device (one process on the CPU).
    Importable for tests; ``main`` adds signal handling around it."""
    if model not in ("mlp", "llama"):
        raise ValueError(f"unknown model {model!r}")
    if trainer_overrides and model != "llama":
        raise ValueError(
            "trainer_overrides (LR schedule / grad clip) apply to the "
            "llama workload only")
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    device = resolve_device(device)
    if n_devices is None:
        n_devices = (torch.cuda.device_count() if device.type == "cuda"
                     else 1)
    if n_devices == 1:
        return _train_loop(checkpoint_dir, max_steps, save_interval, model,
                           trainer_overrides, device, stop_flag)
    stop = spawn_context().Event()
    finished = threading.Event()

    def watch():
        while not finished.wait(0.05):
            if stop_flag is not None and stop_flag():
                stop.set()
                return

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    try:
        results = run_ranks(train_rank, n_devices, checkpoint_dir,
                            max_steps, save_interval, model,
                            trainer_overrides, stop, device=device)
    finally:
        finished.set()
        watcher.join()
    return results[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--checkpoint-dir", required=True)
    parser.add_argument("--max-steps", type=int, default=100)
    parser.add_argument("--save-interval", type=int, default=10)
    parser.add_argument("--n-devices", type=int, default=None,
                        help="ranks over a dp x tp mesh, one per card "
                             "(gloo processes with --device cpu); "
                             "default: every visible card (1 with "
                             "--device cpu)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device)")
    parser.add_argument("--model", choices=("mlp", "llama"),
                        default="mlp",
                        help="workload: tiny regression MLP or the "
                             "Llama-style decoder")
    parser.add_argument("--total-steps", type=int, default=0,
                        help="llama: LR schedule horizon (warmup + "
                             "cosine decay); 0 = constant LR")
    parser.add_argument("--warmup-steps", type=int, default=0,
                        help="llama: linear LR warmup steps")
    parser.add_argument("--grad-clip-norm", type=float, default=0.0,
                        help="llama: global-norm gradient clip; "
                             "0 = off")
    args = parser.parse_args(argv)
    if args.n_devices is not None and args.n_devices < 1:
        parser.error(f"--n-devices must be >= 1, got {args.n_devices}")
    if (args.n_devices or 1) > 1 and args.device in (None, "cuda") \
            and args.n_devices > torch.cuda.device_count():
        parser.error(f"--n-devices {args.n_devices}: "
                     f"{torch.cuda.device_count()} cards visible")
    trainer_overrides = {
        k: v for k, v in (("total_steps", args.total_steps),
                          ("warmup_steps", args.warmup_steps),
                          ("grad_clip_norm", args.grad_clip_norm))
        if v} or None
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    stop = {"flag": False}

    def on_term(signum, _frame):
        # an evicted pod gets SIGTERM: stop cleanly WITHOUT saving —
        # durability must come from the periodic commits the operator's
        # gate verified, not from a grace-period race
        stop["flag"] = True
        if signum == signal.SIGINT:
            # keep the Ctrl-C escape hatch: a second SIGINT raises
            # KeyboardInterrupt even while blocked inside a save
            signal.signal(signal.SIGINT, signal.default_int_handler)

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)
    result = train(args.checkpoint_dir, args.max_steps, args.save_interval,
                   args.device, stop_flag=lambda: stop["flag"],
                   model=args.model, trainer_overrides=trainer_overrides,
                   n_devices=args.n_devices)
    logger.info("exiting at step %d (started from %d)",
                result["final_step"], result["start_step"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
