"""Driver entry points of the port: the one-card probe step and the
multi-device dry run.

The port of ``__graft_entry__.py``. The operator refuses to return an
upgraded GPU node to service until a collective probe proves its fabric
healthy (``health/fabric_probe.py``); :func:`entry` exposes the one-card
probe step, and :func:`dryrun_multichip` runs, on n ranks over the
reference's dp x tp mesh, the workload that gate protects and the probe:

1. ``train``: a dp x tp Llama train step (finite loss, ``wq`` still split
   over tp);
2. ``decode``: the device loop against the host loop, greedy, in the
   parameters' dtype and in int8 weights + int8 KV cache, token for token;
3. ``checkpoint``: save through DCP, the durability gate closed before
   and open after the commit, a restore into another seed's state, and
   the next loss equal bit for bit to the uninterrupted run's;
4. ``fabric``: the probe battery over every shifted ring, and at n >= 2
   the timed bandwidth ring.

The reference's ring-attention, pipeline and MoE stages
(``__graft_entry__.py:226-298``) are not ported yet (``ROADMAP.md``
Queue 1). Run it on the CPU over gloo::

    python -m tpu_operator_libs_torch.multichip --n 4 --device cpu

and on n cards with ``--n n`` (default: every visible card).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import tempfile
import time

import torch

from tpu_operator_libs_torch.examples.llama import (
    LlamaConfig,
    init_llama_params,
    make_token_batch,
    make_train_step,
)
from tpu_operator_libs_torch.examples.llama_decode import (
    generate,
    generate_on_device,
    quantize_params_int8,
)
from tpu_operator_libs_torch.examples.training_job import (
    make_checkpoint_manager,
    restore_state,
)
from tpu_operator_libs_torch.health.checkpoint_gate import (
    CheckpointDurabilityGate,
)
from tpu_operator_libs_torch.health.fabric_probe import (
    fabric_bandwidth_probe,
    fabric_probe_rings,
    single_chip_probe,
)
from tpu_operator_libs_torch.kernels.flash_attention import WRAPPERS
from tpu_operator_libs_torch.parallel import (
    dp_tp_split,
    gather_rows,
    run_ranks,
)

#: the stages :func:`run_stages` runs, in order
STAGES = ("train", "decode", "checkpoint", "fabric")


def entry():
    """(fn, example_args): the one-card probe step, on the card."""
    return single_chip_probe()


def dryrun_config(tp: int) -> LlamaConfig:
    """``__graft_entry__.py``'s dry-run model: widths derived from tp so
    that every axis splits evenly for any n."""
    return LlamaConfig(vocab=16 * tp, d_model=8 * tp, n_layers=1,
                       n_heads=tp, n_kv_heads=tp, d_ff=16 * tp, seq_len=16)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _state(params, optimizer, device):
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def run_stages(mesh, config, ckpt_dir, *, param_dtype=None,
               batch_per_shard: int = 2, train_steps: int = 1,
               prompt_len: int = 4, new_tokens: int = 4,
               decode_rows=None, payload_mib: int = 1,
               rounds: int = 2) -> dict:
    """:data:`STAGES` on this rank (``run_ranks`` runs it on every rank,
    all with one ``ckpt_dir``). Every check raises on failure. Returns
    the numbers each stage measured; ``launches`` counts this rank's
    flash-attention kernel launches over all the stages (set to 0 just
    before the first)."""
    device = mesh.device
    out = {"dp": mesh.dp, "tp": mesh.tp}

    # 1. the train step
    params = init_llama_params(config, param_dtype, mesh=mesh)
    optimizer, step = make_train_step(config, mesh=mesh)
    state = _state(params, optimizer, device)
    batches = [make_token_batch(i, config, batch_per_shard, mesh=mesh)
               for i in range(train_steps + 1)]
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    losses, step_ms = [], []
    for tokens in batches[:train_steps]:
        _sync(device)
        start = time.perf_counter()
        state, loss = step(state, tokens)
        _sync(device)
        step_ms.append((time.perf_counter() - start) * 1e3)
        losses.append(loss)
    out["losses"] = [float(x) for x in losses]
    out["step_ms"] = step_ms
    if not all(map(math.isfinite, out["losses"])):
        raise RuntimeError(f"dp x tp train step losses {out['losses']}")
    wq = state["params"]["layers"][0]["wq"]
    if wq.shape[1] != config.n_heads * config.head_dim // mesh.tp:
        raise RuntimeError(f"wq lost its tensor-parallel split: "
                           f"{tuple(wq.shape)} at tp={mesh.tp}")

    # 2. decode: the device loop against the host loop, token for token
    decode_config = dataclasses.replace(config, attention_impl="xla")
    prompt = gather_rows(batches[0], mesh)[:decode_rows, :prompt_len]
    qparams = quantize_params_int8(state["params"], mesh)
    for label, p, kw in (("plain", state["params"], {}),
                         ("int8_weights_int8_kv", qparams,
                          {"quantize_kv": True})):
        host = generate(p, prompt, decode_config, new_tokens,
                        param_dtype=param_dtype, mesh=mesh, **kw)
        dev = generate_on_device(p, prompt, decode_config, new_tokens,
                                 param_dtype=param_dtype, mesh=mesh, **kw)
        if not torch.equal(host, dev):
            raise RuntimeError(f"device decode diverged from the host loop "
                               f"({label})")
        out[f"decode_{label}"] = dev
    del qparams

    # 3. checkpoint -> gate -> resume, bit for bit
    gate = CheckpointDurabilityGate(ckpt_dir)
    if gate.check():
        raise RuntimeError("durability gate open with no committed "
                           "checkpoint")
    manager = make_checkpoint_manager(ckpt_dir)
    done = int(state["step"])
    _sync(device)
    start = time.perf_counter()
    manager.save(done, state, mesh)
    out["save_s"] = time.perf_counter() - start
    if not gate.check():
        raise RuntimeError("durability gate still closed after a "
                           "committed save")
    next_tokens = batches[train_steps]
    _, loss_uninterrupted = step(state, next_tokens)
    fresh = _state(init_llama_params(config, param_dtype, seed=7, mesh=mesh),
                   optimizer, device)
    start = time.perf_counter()
    restored, start_step = restore_state(manager, fresh, mesh)
    _sync(device)
    out["restore_s"] = time.perf_counter() - start
    if start_step != done:
        raise RuntimeError(f"resume picked step {start_step}, wanted {done}")
    _, loss_resumed = step(restored, next_tokens)
    if not torch.equal(loss_uninterrupted, loss_resumed):
        raise RuntimeError(
            f"resumed step diverged: {float(loss_resumed)!r} != "
            f"{float(loss_uninterrupted)!r}")
    out["resumed_loss"] = float(loss_resumed)
    out["saved_bytes"] = sum(os.path.getsize(os.path.join(d, f))
                             for d, _, files in os.walk(ckpt_dir)
                             for f in files)
    del state, restored, fresh
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # 4. the fabric
    rings = fabric_probe_rings(mesh)
    if not all(r.healthy for r in rings):
        raise RuntimeError(f"fabric probe failed: {[str(r) for r in rings]}")
    out["fabric"] = [dataclasses.asdict(r) for r in rings]
    if mesh.size >= 2:
        bw = fabric_bandwidth_probe(mesh, payload_mib=payload_mib,
                                    rounds=rounds)
        out["bandwidth"] = dataclasses.asdict(bw)
    out["launches"] = {name: wrapper.launches
                       for name, wrapper in WRAPPERS.items()}
    return out


def dryrun_rank(mesh, ckpt_dir) -> dict:
    """One rank of :func:`dryrun_multichip`."""
    return run_stages(mesh, dryrun_config(mesh.tp), ckpt_dir)


def dryrun_multichip(n_devices: int, *, device=None) -> "list[dict]":
    """Run :data:`STAGES` on ``n_devices`` ranks (cards, or gloo
    processes with ``device="cpu"``), print which stages ran and what
    they gave, and return every rank's result. Raises on any failure."""
    dp, tp = dp_tp_split(n_devices)
    with tempfile.TemporaryDirectory(prefix="dryrun_ckpt_") as ckpt_dir:
        results = run_ranks(dryrun_rank, n_devices, ckpt_dir, device=device)
    first = results[0]
    rings = first["fabric"]
    bw = first.get("bandwidth")
    print(f"dryrun_multichip OK: stages {', '.join(STAGES)}; dp={dp} "
          f"tp={tp}, loss={first['losses'][0]:.5f}, decode dp x tp exact "
          f"(plain and int8-weights+int8-KV), ckpt-resume bit-identical "
          f"(gate closed->open on commit), fabric {len(rings)} ring(s) "
          f"max|err|={max(r['max_abs_error'] for r in rings):.3e}"
          + (f", bandwidth {bw['gbytes_per_s']} GByte/s" if bw else "")
          + "; not ported yet: ring attention, pipeline, MoE")
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--n", type=int, default=None,
                        help="ranks (default: every visible card; 4 with "
                             "--device cpu)")
    parser.add_argument("--device", default=None,
                        help="'cpu' for gloo processes (default: the "
                             "cards)")
    args = parser.parse_args(argv)
    n = args.n
    if n is None:
        n = 4 if args.device == "cpu" else torch.cuda.device_count()
    fn, probe_args = single_chip_probe(device=args.device)
    out = fn(*probe_args)
    print(f"entry OK: {tuple(out.shape)} {out.dtype}")
    dryrun_multichip(n, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
