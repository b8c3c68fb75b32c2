"""Driver entry points of the port: the one-card probe step and the
multi-device dry run.

The port of ``__graft_entry__.py``. The operator refuses to return an
upgraded GPU node to service until a collective probe proves its fabric
healthy (``health/fabric_probe.py``); :func:`entry` exposes the one-card
probe step, and :func:`dryrun_multichip` runs, on n ranks over the
reference's dp x tp mesh, the workload that gate protects and the probe:

1. ``train``: a dp x tp Llama train step (finite loss, ``wq`` still split
   over tp);
2. ``decode``: the device loop (on the cards one CUDA graph of the step
   replayed a token on every rank) against the host loop, greedy, in the
   parameters' dtype and in int8 weights + int8 KV cache, token for
   token, and when asked the two timed at a bench shape;
3. ``checkpoint``: save through DCP, the durability gate closed before
   and open after the commit, a restore into another seed's state, and
   the next loss equal bit for bit to the uninterrupted run's;
4. ``fabric``: the probe battery over every shifted ring, and at n >= 2
   the timed bandwidth ring;
5. ``ring``: ring attention over a 1-D sp mesh of every rank against
   dense attention (and, when asked, a ring Llama on a 1 x n dp x sp
   mesh: its forward against the one-card flash forward, and train
   steps);
6. ``pipeline``: the GPipe schedule over a 1-D pp mesh against the
   layers run in order on one device;
7. ``moe``: the experts over a 1-D ep mesh, all-gather dispatch against
   the dense reference and the capacity-bounded all-to-all against its
   one-device counterpart, drops counted exactly;

at ``__graft_entry__.py:219-280``'s shapes and tolerance (1e-4), but for
the ring's head_dim: 16, not 8, the narrowest the kernels are built for.
Run it on the CPU over gloo::

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

from tpu_operator_libs_torch.examples import moe as moe_lib
from tpu_operator_libs_torch.examples.llama import (
    LlamaConfig,
    forward,
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
from tpu_operator_libs_torch.examples.pipeline import (
    init_stage_params,
    make_pipeline,
    sequential_reference,
)
from tpu_operator_libs_torch.examples.ring_attention import (
    dense_reference,
    make_ring_attention,
)
from tpu_operator_libs_torch.kernels import (
    WRAPPERS,
    restore_launches,
    save_launches,
)
from tpu_operator_libs_torch.parallel import (
    dp_tp_split,
    gather_rows,
    local_seq,
    make_mesh,
    run_ranks,
)

#: the stages :func:`run_stages` runs, in order
STAGES = ("train", "decode", "checkpoint", "fabric", "ring", "pipeline",
          "moe")
#: the ring, pipeline and moe stages against their one-device
#: references: ``__graft_entry__.py:235, 260, 279``
PARALLEL_TOL = 1e-4
#: the ring Llama's bf16 logits against the one-card flash forward's: the
#: two round to bf16 at different points through the layers (each ring
#: block's output once more before the f32 fold); a wrong position,
#: mask or block moves logits by O(1) of their scale
RING_LOGITS_REL_TOL = 5e-2


#: ``__graft_entry__.py:228-271``'s fixed sizes: the ring stage's
#: (batch, positions a rank, heads, head_dim) (head_dim 16, not 8: the
#: narrowest the kernels are built for), the pipeline's layers a rank
#: and the experts a rank; the all-to-all's capacity factor
RING_SHAPE = (2, 8, 2, 16)
LAYERS_PER_RANK = 2
EXPERTS_PER_RANK = 2
CAPACITY_FACTOR = 1.25
#: the ring Llama's forward (batch 1, this many positions), its train
#: steps and their global batch
RING_LLAMA_FORWARD_SEQ = 8192
RING_LLAMA_STEPS = 3
RING_LLAMA_BATCH = 16


@dataclasses.dataclass(frozen=True)
class ParallelShapes:
    """The sizes of the pipeline and moe stages that differ between the
    dry run (these defaults, ``__graft_entry__.py``'s) and a full-width
    run, and the ring Llama a full-width run trains."""

    #: the pipeline's and the experts' widths
    d_model: int = 16
    d_hidden: int = 32
    #: the pipeline's (microbatches, rows a microbatch)
    microbatches: "tuple[int, int]" = (4, 2)
    #: the experts' tokens a rank
    tokens_per_rank: int = 4
    #: an ``attention_impl="ring"`` Llama to run on the 1 x n dp x sp mesh
    #: (None: the ring stage checks the attention alone)
    ring_llama: "LlamaConfig | None" = None


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


def _timed(fn, device):
    """(fn(), the wall milliseconds of a second call, synchronised): the
    first call pays for the communicators and libraries it sets up."""
    fn()
    _sync(device)
    start = time.perf_counter()
    value = fn()
    _sync(device)
    return value, (time.perf_counter() - start) * 1e3


def _randn(shape, seed, device):
    """The same numbers on every rank: a generator seeded alike."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device)


def _max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def _check(stage, err, tol=PARALLEL_TOL):
    if not err <= tol:
        raise RuntimeError(f"{stage} diverged from its reference: "
                           f"max|err| {err} > {tol}")


def _state(params, optimizer, device):
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def run_stages(mesh, config, ckpt_dir, *, param_dtype=None,
               batch_per_shard: int = 2, train_steps: int = 1,
               prompt_len: int = 4, new_tokens: int = 4,
               decode_rows=None, payload_mib: int = 1,
               rounds: int = 2, shapes: ParallelShapes = ParallelShapes(),
               decode_bench=None) -> dict:
    """:data:`STAGES` on this rank (``run_ranks`` runs it on every rank,
    all with one ``ckpt_dir``). Every check raises on failure. Returns
    the numbers each stage measured; ``launches`` counts this rank's
    kernel launches over stages 1-4 (set to 0 just before the first),
    ``launches_ring`` those of the ring stage (likewise), and
    ``launches_by_design`` and ``launches_by_design_ring`` the flash
    kernels' among them by design. The decode
    stage returns both loops' tokens and this rank's
    ``generate_on_device.last_call`` for each; ``decode_bench``, a
    (global prompt, new tokens) pair, also times the two loops there
    from the untrained parameters (:func:`_decode_bench`)."""
    device = mesh.device
    out = {"dp": mesh.dp, "tp": mesh.tp}

    # 1. the train step
    params = init_llama_params(config, param_dtype, mesh=mesh)
    optimizer, step = make_train_step(config, mesh=mesh)
    state = _state(params, optimizer, device)
    batches = [make_token_batch(i, config, batch_per_shard, mesh=mesh)
               for i in range(train_steps + 1)]
    _reset_launches()
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
        out[f"decode_{label}_host"] = host
        out[f"decode_{label}_loop"] = dict(generate_on_device.last_call)
    del qparams
    if decode_bench is not None:
        out["decode_bench"] = _decode_bench(params, decode_config,
                                            param_dtype, mesh, *decode_bench)

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
    out["launches"] = _launches()
    out["launches_by_design"] = _launches_by_design()
    out.update(_parallel_stages(mesh, shapes, param_dtype))
    return out


def _decode_bench(params, config, param_dtype, mesh, prompt,
                  new_tokens) -> dict:
    """The device loop timed against the host loop on one global
    ``prompt``, in the parameters' dtype (``plain``) and in int8 weights +
    int8 KV: for each loop its wall seconds up to the tokens on the host,
    tokens per second over the global batch's new tokens and its tokens,
    which must be equal; for the device loop, this rank's
    ``generate_on_device.last_call``."""
    prompt = torch.as_tensor(prompt, device=mesh.device)
    cells = {}
    for label, p, kw in (("plain", params, {}),
                         ("int8_weights_int8_kv",
                          quantize_params_int8(params, mesh),
                          {"quantize_kv": True})):
        cell = {}
        for loop, fn in (("graph", generate_on_device), ("host", generate)):
            _sync(mesh.device)
            start = time.perf_counter()
            tokens = fn(p, prompt, config, new_tokens,
                        param_dtype=param_dtype, mesh=mesh, **kw).cpu()
            seconds = time.perf_counter() - start
            cell[loop] = {"seconds": seconds, "tokens": tokens,
                          "tok_per_s": prompt.shape[0] * new_tokens / seconds}
            if loop == "graph":
                cell[loop]["device_loop"] = dict(generate_on_device.last_call)
        if not torch.equal(cell["graph"]["tokens"], cell["host"]["tokens"]):
            raise RuntimeError(f"bench decode: the graph and the host loop "
                               f"differ ({label})")
        cells[label] = cell
    return cells


def _reset_launches() -> None:
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
        if hasattr(wrapper, "launches_by_design"):
            wrapper.launches_by_design.clear()


def _launches() -> "dict[str, int]":
    return {name: wrapper.launches for name, wrapper in WRAPPERS.items()}


def _launches_by_design() -> "dict[str, dict[str, int]]":
    """The flash kernels' launches by the design their instance ran
    (``kernel_design``'s names)."""
    return {name: dict(wrapper.launches_by_design)
            for name, wrapper in WRAPPERS.items()
            if hasattr(wrapper, "launches_by_design")}


def _parallel_stages(mesh, shapes: ParallelShapes, param_dtype) -> dict:
    """Stages 5-7 on 1-D meshes of every rank (and the ring Llama on a
    1 x n dp x sp mesh); each stage's error, limit and milliseconds."""
    device, n = mesh.device, mesh.size
    out = {}

    # 5. ring attention against dense attention
    _reset_launches()
    sp_mesh = make_mesh(shape={"sp": n}, device=device)
    batch, seq, heads, head_dim = RING_SHAPE
    q, k, v = (_randn((batch, seq * n, heads, head_dim), seed, device)
               for seed in (11, 12, 13))
    ring, ring_ms = _timed(lambda: make_ring_attention(sp_mesh)(q, k, v),
                           device)
    err = _max_err(ring, dense_reference(q, k, v))
    _check("ring attention", err)
    out["ring"] = {"sp": n, "shape": list(q.shape), "max_abs_err": err,
                   "tol": PARALLEL_TOL, "ms": ring_ms}
    if shapes.ring_llama is not None:
        out["ring"]["llama"] = _ring_llama(n, shapes.ring_llama,
                                           param_dtype, device)
    out["launches_ring"] = _launches()
    out["launches_by_design_ring"] = _launches_by_design()

    # 6. the GPipe schedule against the layers in order
    pp_mesh = make_mesh(shape={"pp": n}, device=device)
    params = init_stage_params(LAYERS_PER_RANK * n, shapes.d_model,
                               shapes.d_hidden, n, seed=2, device=device)
    micro = _randn((*shapes.microbatches, shapes.d_model), 3, device)
    piped, pp_ms = _timed(lambda: make_pipeline(pp_mesh)(params, micro),
                          device)
    err = _max_err(piped, sequential_reference(params, micro))
    _check("pipeline", err)
    out["pipeline"] = {"pp": n, "layers": params["w1"].shape[0],
                       "microbatches": list(micro.shape),
                       "max_abs_err": err, "tol": PARALLEL_TOL, "ms": pp_ms}
    del params, micro, piped

    # 7. the experts, both dispatch modes
    ep_mesh = make_mesh(shape={"ep": n}, device=device)
    n_experts = EXPERTS_PER_RANK * n
    params = moe_lib.init_moe_params(n_experts, shapes.d_model,
                                     shapes.d_hidden, seed=4, device=device)
    tokens = _randn((shapes.tokens_per_rank * n, shapes.d_model), 5, device)
    gathered, gather_ms = _timed(
        lambda: moe_lib.make_moe(ep_mesh, n_experts)(params, tokens), device)
    gather_err = _max_err(gathered, moe_lib.dense_reference(params, tokens))
    _check("moe (all-gather)", gather_err)
    cf = CAPACITY_FACTOR
    (sent, dropped), a2a_ms = _timed(
        lambda: moe_lib.make_moe(ep_mesh, n_experts, dispatch="all_to_all",
                                 capacity_factor=cf)(params, tokens), device)
    want, want_dropped = moe_lib.capacity_reference(params, tokens, n, cf)
    a2a_err = _max_err(sent, want)
    _check("moe (all-to-all)", a2a_err)
    if int(dropped) != want_dropped:
        raise RuntimeError(f"moe (all-to-all) dropped {int(dropped)} "
                           f"tokens, the plain count is {want_dropped}")
    out["moe"] = {"ep": n, "experts": n_experts,
                  "tokens": list(tokens.shape), "tol": PARALLEL_TOL,
                  "gather": {"max_abs_err": gather_err, "ms": gather_ms},
                  "all_to_all": {"max_abs_err": a2a_err, "ms": a2a_ms,
                                 "capacity_factor": cf,
                                 "dropped": int(dropped),
                                 "plain_dropped": want_dropped}}
    return out


def _ring_llama(n, config, param_dtype, device) -> dict:
    """The ring Llama on a 1 x n dp x sp mesh: its forward at batch 1
    against the one-card flash forward's logits (this rank's block of
    them), then train steps; the kernels' launches count into the ring
    stage's."""
    mesh = make_mesh(shape={"dp": 1, "sp": n}, device=device)
    params = init_llama_params(config, param_dtype, mesh=mesh)
    long = dataclasses.replace(config, seq_len=RING_LLAMA_FORWARD_SEQ)
    tokens = make_token_batch(0, long, 1, device=device)
    with torch.no_grad():
        ring, fwd_ms = _timed(
            lambda: forward(params, local_seq(tokens, mesh), long, mesh),
            device)
        before = save_launches()
        flash = local_seq(forward(
            params, tokens, dataclasses.replace(long, attention_impl="flash")),
            mesh)
        restore_launches(before)  # the yardstick is not the path
    rel = ((ring.float() - flash.float()).abs().max()
           / flash.float().abs().max()).item()
    if not rel <= RING_LOGITS_REL_TOL:
        raise RuntimeError(f"ring Llama logits off the flash forward's by "
                           f"{rel} (max-relative)")
    result = {"forward_seq": long.seq_len, "forward_ms": fwd_ms,
              "logits_rel_err": rel, "rel_tol": RING_LOGITS_REL_TOL,
              "logits_bit_equal_to_flash": bool(torch.equal(ring, flash))}
    del ring, flash
    optimizer, step = make_train_step(config, mesh=mesh)
    state = _state(params, optimizer, device)
    losses, step_ms = [], []
    for i in range(RING_LLAMA_STEPS):
        batch = make_token_batch(i, config, RING_LLAMA_BATCH, mesh=mesh)
        _sync(device)
        start = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - start) * 1e3)
    if not all(map(math.isfinite, losses)):
        raise RuntimeError(f"ring Llama losses {losses}")
    result.update({"batch": RING_LLAMA_BATCH, "seq": config.seq_len,
                   "losses": losses, "step_ms": step_ms})
    return result


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
    moe = first["moe"]
    print(f"dryrun_multichip OK: stages {', '.join(STAGES)}; dp={dp} "
          f"tp={tp}, loss={first['losses'][0]:.5f}, decode dp x tp exact "
          f"(plain and int8-weights+int8-KV), ckpt-resume bit-identical "
          f"(gate closed->open on commit), fabric {len(rings)} ring(s) "
          f"max|err|={max(r['max_abs_error'] for r in rings):.3e}"
          + (f", bandwidth {bw['gbytes_per_s']} GByte/s" if bw else "")
          + f", ring-attn sp={n_devices} "
          f"max|err|={first['ring']['max_abs_err']:.2e}, pipeline "
          f"pp={n_devices} max|err|={first['pipeline']['max_abs_err']:.2e},"
          f" moe ep={n_devices} max|err|="
          f"{moe['gather']['max_abs_err']:.2e} (all-to-all "
          f"{moe['all_to_all']['max_abs_err']:.2e}, "
          f"{moe['all_to_all']['dropped']} dropped)")
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
