"""The ranks of a tensor-parallel pod in a benchmark run.

Rank 0 is the run's own process: it serves the cell's traffic through
the port's ``DecodeServer`` (``drivers/serve_closed_tp.py``), so the
harness's profiler, its spans and its check of loaded modules see it.
Ranks 1 .. n-1 are processes of ``parallel.spawn_context()`` that run
:func:`follower`: they make the same weights, keep their shards and sit
in ``DecodeServer.serve()`` until rank 0's ``shutdown()``. Every rank
joins one process group (NCCL on the cards, rank i on card i; gloo on
the CPU, where the tests drive a run) through a ``file://`` store in a
fresh temporary directory, and builds the mesh ``{"dp": 1, "tp": n}``.

Each rank makes the model one layer at a time from the run's seed
(``weights.make_layer``, ``weights.make_ends``), keeps its tp shards
(``convert.shard_params``) and frees the whole layer before the next:
the whole model never sits on one card.

Each rank runs on its own equal share of the run's cores
(:func:`core_shares`), with as many intra-op threads, so that the
ranks' dispatch threads, which set each request's pace, do not compete
for cores.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_lib
import sys
import tempfile
import threading
import traceback

import torch
import torch.distributed as dist

from port_bench import weights

#: a collective that waits longer than this fails its process instead of
#: hanging the run (a rank that died leaves its peers waiting)
TIMEOUT = datetime.timedelta(seconds=300)
#: seconds rank 0 waits for the followers' reports after the last round
REPORT_SECONDS = 60.0


def shard_model(c, seed: int, mesh, dtype) -> dict:
    """This rank's shards of the model of the run's seed, made one layer
    at a time on the mesh's device."""
    from tpu_operator_libs_torch.convert import shard_params

    device = mesh.device
    ends = weights.make_ends(c, seed, device, dtype)
    params = shard_params(ends, mesh)
    del ends
    params["layers"] = []
    for i in range(c.n_layers):
        layer = weights.make_layer(c, seed, i, device, dtype)
        params["layers"].append(shard_params(layer, mesh))
        del layer
    return params


@dataclasses.dataclass(frozen=True)
class Spec:
    """What a follower needs to build its part of the pod: plain values,
    so that it pickles."""

    model: dict
    seed: int
    dtype: str
    new_tokens: int
    temperature: float
    quantize_kv: bool
    world: int
    init_method: str
    device_type: str
    cores: tuple  # each rank's cores (:func:`core_shares`)


def core_shares(world: int) -> tuple:
    """The run's cores cut into ``world`` equal runs of consecutive ids,
    one a rank; empty ones where the run has fewer cores than ranks."""
    cores = sorted(os.sched_getaffinity(0))
    n = len(cores) // world
    return tuple(tuple(cores[r * n:(r + 1) * n]) for r in range(world))


def pin(cores) -> None:
    """This process onto ``cores``, with one intra-op thread each
    (nothing where ``cores`` is empty)."""
    if cores:
        os.sched_setaffinity(0, cores)
        torch.set_num_threads(len(cores))


def _join(rank: int, spec: Spec):
    """Join the process group and build the mesh; returns it."""
    from tpu_operator_libs_torch.parallel import make_mesh

    if spec.device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    dist.init_process_group(
        "nccl" if spec.device_type == "cuda" else "gloo",
        init_method=spec.init_method, world_size=spec.world, rank=rank,
        timeout=TIMEOUT)
    return make_mesh(spec.world, device=device,
                     shape={"dp": 1, "tp": spec.world})


def build_server(spec: Spec, mesh, endpoint):
    """This rank's ``DecodeServer`` over the mesh."""
    from tpu_operator_libs_torch.examples.llama import LlamaConfig
    from tpu_operator_libs_torch.examples.llama_serving_job import (
        DecodeServer,
    )

    config = LlamaConfig(**spec.model)
    config.validate_for(mesh.tp)
    params = shard_model(config, spec.seed, mesh,
                         getattr(torch, spec.dtype))
    return DecodeServer(config, params, endpoint,
                        max_new_tokens=spec.new_tokens,
                        temperature=spec.temperature,
                        quantize_kv=spec.quantize_kv, mesh=mesh)


def follower(rank: int, spec: Spec, results) -> None:
    """Rank ``rank`` >= 1: its part of the pod, serving rounds until rank
    0 says stop; reports ``(rank, ok, {"served", "peak_bytes"} or a
    traceback)`` before it leaves the process group, which NCCL leaves
    with every rank at once."""
    try:
        from tpu_operator_libs_torch.health.serving_gate import (
            ServingEndpoint,
        )

        pin(spec.cores[rank])
        mesh = _join(rank, spec)
        try:
            server = build_server(spec, mesh,
                                  ServingEndpoint(f"port-bench-{rank}"))
            served = server.serve()
            peak = (torch.cuda.max_memory_allocated(mesh.device)
                    if spec.device_type == "cuda" else 0)
            results.put((rank, True, {"served": served,
                                      "peak_bytes": peak}))
        finally:
            dist.destroy_process_group()
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        raise


class Ranks:
    """Rank 0's side of the pod's processes: starts the followers, joins
    the process group and builds the mesh (:attr:`mesh`); :meth:`finish`
    collects the followers' reports once rank 0 has stopped them. A
    follower that exits before then leaves rank 0 waiting in a collective
    that never completes, so a watcher thread ends the run at once with
    exit code 1."""

    def __init__(self, ctx):
        from tpu_operator_libs_torch import parallel

        self._tmp = tempfile.TemporaryDirectory(prefix="pod_")
        on_card = str(ctx.device).startswith("cuda")
        self.spec = Spec(
            model=dataclasses.asdict(ctx.model), seed=ctx.seed,
            dtype=ctx.config["precision"]["params"],
            new_tokens=ctx.traffic["new_tokens"],
            temperature=ctx.traffic["temperature"],
            quantize_kv=ctx.config["precision"]["kv_cache"] == "int8",
            world=ctx.cell["chips"],
            init_method=f"file://{self._tmp.name}/store",
            device_type="cuda" if on_card else "cpu",
            cores=core_shares(ctx.cell["chips"]))
        mp = parallel.spawn_context()
        self._results = mp.Queue()
        self._procs = [mp.Process(target=follower, daemon=True,
                                  args=(rank, self.spec, self._results))
                       for rank in range(1, self.spec.world)]
        for p in self._procs:
            p.start()
        self._finishing = threading.Event()
        threading.Thread(target=self._watch, daemon=True).start()
        # rank 0 takes its share once the followers have started, and
        # gives it back in :meth:`finish`
        self._unpinned = (os.sched_getaffinity(0), torch.get_num_threads())
        pin(self.spec.cores[0])
        try:
            self.mesh = _join(0, self.spec)
        except BaseException:
            self._kill()
            self._unpin()
            raise

    def _watch(self) -> None:
        while not self._finishing.wait(1.0):
            dead = {rank: p.exitcode for rank, p in
                    enumerate(self._procs, start=1) if p.exitcode is not None}
            if dead:
                print(f"port_bench: pod ranks {dead} (rank: exit code) "
                      "left before the pod stopped", file=sys.stderr,
                      flush=True)
                os._exit(1)

    def finish(self, stopped: bool) -> "list[dict]":
        """The followers' reports, in rank order, once ``stopped`` (rank 0
        sent the last round), and the process group left with them;
        without it (rank 0 failed) the followers are killed and nothing
        is reported."""
        self._finishing.set()
        try:
            if not stopped:
                return []
            got = {}
            while len(got) < len(self._procs):
                try:
                    rank, ok, payload = self._results.get(
                        timeout=REPORT_SECONDS)
                except queue_lib.Empty:
                    raise RuntimeError(
                        "the pod's followers gave no report within "
                        f"{REPORT_SECONDS} s") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                got[rank] = payload
            # every rank leaves NCCL's communicators together
            dist.destroy_process_group()
            for p in self._procs:
                p.join(timeout=60.0)
            return [got[r] for r in sorted(got)]
        finally:
            self._kill()
            if dist.is_initialized() and self.spec.device_type != "cuda":
                dist.destroy_process_group()
            self._tmp.cleanup()
            self._unpin()

    def _unpin(self) -> None:
        cores, threads = self._unpinned
        os.sched_setaffinity(0, cores)
        torch.set_num_threads(threads)

    def _kill(self) -> None:
        self._finishing.set()
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
