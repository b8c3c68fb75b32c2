"""Rank functions for the port's multi-rank tests (``parallel.run_ranks``
starts them in fresh processes); the module holds no tests of its own.
It imports torch and the port, never jax: a child that imported a test module would import jax too, with
its platform plugin and XLA flags. Inputs arrive as numpy arrays and
plain values; results go back as numpy arrays.

Some of the functions break one collective on purpose, to show that the
tests would catch its absence: ``variant="no_copy_to_tp"`` drops the
all-reduce of ``copy_to_tp``'s backward, ``variant="local_clip"`` takes
the clip's norm over this rank's shards only,
:func:`probe_with_a_corrupt_sender` makes rank 1 send a wrong tile, and
:func:`sp_train_rank` also trains without the gradients' sum over sp.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

import threading

from tpu_operator_libs_torch import optim
from tpu_operator_libs_torch.convert import shard_params, \
    stacked_params_from_jax
from tpu_operator_libs_torch.examples import llama, llama_decode, moe
from tpu_operator_libs_torch.examples import llama_serving_job as serving
from tpu_operator_libs_torch.examples import pipeline as pp_lib
from tpu_operator_libs_torch.examples import ring_attention as ring
from tpu_operator_libs_torch.examples import training_job as job
from tpu_operator_libs_torch.health import fabric_probe
from tpu_operator_libs_torch.parallel import (
    gather_axis,
    local_rows,
    local_seq,
    make_mesh,
    mean_over_dp,
)


def _tensors(tree, dtype=None):
    """numpy leaves of nested dicts and lists as torch tensors (floating
    ones cast to ``dtype`` when given)."""
    if isinstance(tree, dict):
        return {k: _tensors(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, dtype) for v in tree]
    t = torch.from_numpy(np.array(tree))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def _replicated_grads(grads):
    out = {"embed": grads["embed"], "final_norm": grads["final_norm"]}
    for i, layer in enumerate(grads["layers"]):
        out[f"attn_norm{i}"] = layer["attn_norm"]
        out[f"mlp_norm{i}"] = layer["mlp_norm"]
    return out


def tp_train_rank(mesh, params_np, config_kw, tokens_np, variant="plain"):
    """Logits of batch 0, the step-0 gradients of the replicated leaves
    (after the dp mean), then ``len(tokens_np)`` AdamW steps from JAX's
    parameters: returns the losses and this rank's shards."""
    if variant == "no_copy_to_tp":
        llama.copy_to_tp = lambda x, mesh: x
    elif variant == "local_clip":
        orig = optim.global_norm
        optim.global_norm = lambda grads, mesh=None: orig(grads, None)
    elif variant != "plain":
        raise ValueError(variant)
    config = llama.LlamaConfig(**config_kw)
    params = shard_params(_tensors(params_np), mesh)
    batches = [local_rows(torch.from_numpy(t), mesh) for t in tokens_np]
    with torch.no_grad():
        logits = llama.forward(params, batches[0], config, mesh)
    loss, grads = optim.value_and_grad(llama.next_token_loss, params,
                                       batches[0], config, mesh)
    grads = optim.tree_map(lambda g: mean_over_dp(g, mesh), grads)
    optimizer, step = llama.make_train_step(config, mesh=mesh)
    state = {"params": params, "opt": optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    losses = []
    for tokens in batches:
        state, loss = step(state, tokens)
        losses.append(float(loss))
    return {"logits": logits, "replicated_grads": _replicated_grads(grads),
            "losses": losses, "params": state["params"],
            "dp_rank": mesh.dp_rank, "tp_rank": mesh.tp_rank}


def tp_decode_rank(mesh, params_np, config_kw, prompt_np, new_tokens,
                   dtype_name):
    """Greedy tokens of both loops, plain and int8 weights + int8 KV, from
    JAX's parameters cast to ``dtype_name``, with this rank's device loop
    (``generate_on_device.last_call``); sampled tokens, and both loops'
    sampled tokens and logprobs with an eos; this rank's int8 scales; and
    what the device loop says of this (gloo) mesh on the card."""
    dtype = getattr(torch, dtype_name)
    config = llama.LlamaConfig(**config_kw)
    params = shard_params(_tensors(params_np, dtype), mesh)
    qparams = llama_decode.quantize_params_int8(params, mesh)
    prompt = torch.from_numpy(prompt_np)
    out = {"scales": {name: qparams["layers"][0][name]["s"]
                      for name in ("wq", "wo", "w_up", "w_down")}}
    out["scales"]["lm_head"] = qparams["lm_head"]["s"]
    for label, p, kw in (("plain", params, {}),
                         ("int8", qparams, {"quantize_kv": True})):
        out[f"host_{label}"] = llama_decode.generate(
            p, prompt, config, new_tokens, param_dtype=dtype, mesh=mesh,
            **kw)
        out[f"device_{label}"] = llama_decode.generate_on_device(
            p, prompt, config, new_tokens, param_dtype=dtype, mesh=mesh,
            **kw)
        out[f"device_{label}_loop"] = dict(
            llama_decode.generate_on_device.last_call)
    # sampling: every rank gets an equally seeded generator
    out["sampled"] = llama_decode.generate_on_device(
        params, prompt, config, new_tokens, param_dtype=dtype, mesh=mesh,
        temperature=1.0, top_k=8, generator=torch.Generator().manual_seed(0))

    def sampled(fn, **kw):
        return fn(qparams, prompt, config, new_tokens, param_dtype=dtype,
                  mesh=mesh, quantize_kv=True, temperature=1.0, top_k=8,
                  top_p=0.9, return_logprobs=True,
                  generator=torch.Generator().manual_seed(1), **kw)

    # the eos: the token row 0 draws at its third step without one
    eos = int(sampled(llama_decode.generate)[0][0, prompt.shape[1] + 2])
    host, host_lp = sampled(llama_decode.generate, eos_id=eos)
    dev, dev_lp = sampled(llama_decode.generate_on_device, eos_id=eos)
    out["sampled_eos"] = {
        "eos_id": eos, "host": host, "host_logprobs": host_lp,
        "device": dev, "device_logprobs": dev_lp,
        "device_loop": dict(llama_decode.generate_on_device.last_call)}
    try:
        llama_decode._captures(torch.device("cuda"), mesh)
        out["on_the_card"] = "captured"
    except ValueError as exc:
        out["on_the_card"] = str(exc)
    return out


def probe_with_a_corrupt_sender(mesh):
    """The probe battery while rank 1 sends a tile one too large around
    every ring: a link that delivers wrong data."""
    orig = fabric_probe._ring_pass

    def corrupt(x, shift):
        return orig(x + 1 if dist.get_rank() == 1 else x, shift)

    fabric_probe._ring_pass = corrupt
    return fabric_probe.probe_node_rank(mesh, 1e-3, None, None)


def checkpoint_shards_rank(mesh, ckpt_dir):
    """Save a trained llama state at this rank's tp, restore it into a
    state from another seed, and report whether every leaf came back bit
    for bit, with the keys DCP wrote."""
    state, step, config = job.init_state_llama(mesh.device, mesh=mesh)
    state, _ = step(state, llama.make_token_batch(0, config, mesh=mesh))
    manager = job.make_checkpoint_manager(ckpt_dir)
    manager.save(1, state, mesh)
    fresh = {"params": llama.init_llama_params(config, seed=7, mesh=mesh),
             "opt": None, "step": torch.zeros((), dtype=torch.int32)}
    fresh["opt"] = optim.tree_map(torch.zeros_like, state["opt"])
    differed = sum(not torch.equal(a, b) for a, b in zip(
        optim.tree_leaves(state), optim.tree_leaves(fresh)))
    restored, start = job.restore_state(manager, fresh, mesh)
    equal = [torch.equal(a, b) for a, b in zip(
        optim.tree_leaves(state), optim.tree_leaves(restored))]
    reader = dcp.FileSystemReader(os.path.join(ckpt_dir, "1"))
    keys = sorted(reader.read_metadata().state_dict_metadata)
    return {"start": start, "leaves": len(equal), "equal": sum(equal),
            "differed_before": differed, "keys": keys,
            "wq_shape": tuple(state["params"]["layers"][0]["wq"].shape)}


def ring_cases_rank(mesh, cases):
    """Ring attention on a 1-D sp mesh of every rank for each case
    ``{"q", "k", "v", "causal", "dtype", "grads"}`` (global numpy
    (B, S, H, D) inputs): the gathered output, its dtype, and with
    ``grads`` the gradients of sum(out ** 2) for q, k and v, each rank
    differentiating its own block's part."""
    results = []
    for case in cases:
        dtype = getattr(torch, case["dtype"])
        q, k, v = (torch.from_numpy(case[x]).to(dtype) for x in "qkv")
        run = ring.make_ring_attention(mesh, causal=case["causal"])
        out = run(q, k, v)
        result = {"out": out, "dtype": str(out.dtype)}
        if case["grads"]:
            blocks = [local_seq(x, mesh).clone().requires_grad_()
                      for x in (q, k, v)]
            local = ring.ring_attention(*blocks, mesh, case["causal"])
            (local.float() ** 2).sum().backward()
            result["grads"] = [gather_axis(b.grad, mesh, "sp", dim=1)
                               for b in blocks]
        results.append(result)
    return results


def sp_train_rank(mesh, params_np, config_kw, tokens_np):
    """The ring Llama on a dp x sp mesh from JAX's parameters and JAX's
    global token batches (each rank takes its rows and its block of the
    sequence): the logits of batch 0 (this rank's block), then
    ``len(tokens_np)`` steps; and the same steps again without the sum
    of the gradients over sp."""
    config = llama.LlamaConfig(**config_kw)
    batches = [local_seq(local_rows(torch.from_numpy(t), mesh), mesh)
               for t in tokens_np]
    with torch.no_grad():
        logits = llama.forward(_tensors(params_np), batches[0], config,
                               mesh)

    def train():
        params = _tensors(params_np)
        optimizer, step = llama.make_train_step(config, mesh=mesh)
        state = {"params": params, "opt": optimizer.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        losses = []
        for tokens in batches:
            state, loss = step(state, tokens)
            losses.append(float(loss))
        return losses, state["params"]

    losses, params = train()
    summed = llama.sum_over
    llama.sum_over = lambda x, mesh, name: x
    try:
        unsummed_losses, _ = train()
    finally:
        llama.sum_over = summed
    return {"logits": logits, "losses": losses, "params": params,
            "unsummed_losses": unsummed_losses, "dp_rank": mesh.dp_rank,
            "sp_rank": mesh.sp_rank}


def pipeline_moe_rank(mesh, cases):
    """Each case on 1-D pp and ep meshes of every rank, from JAX's
    parameters: ``{"kind": "pipeline", "params", "x"}`` gives the
    pipeline's output; ``{"kind": "moe", "params", "tokens",
    "n_experts", "dispatch", "capacity_factor", "dtype"}`` the MoE's
    output (and the drops, all-to-all)."""
    meshes = {"pipeline": make_mesh(shape={"pp": mesh.size},
                                    device=mesh.device),
              "moe": make_mesh(shape={"ep": mesh.size}, device=mesh.device)}
    results = []
    for case in cases:
        sub = meshes[case["kind"]]
        params = stacked_params_from_jax(case["params"], device="cpu")
        if case["kind"] == "pipeline":
            out = pp_lib.make_pipeline(sub)(params,
                                            torch.from_numpy(case["x"]))
            results.append({"out": out})
            continue
        dtype = getattr(torch, case["dtype"])
        params = {k: (v if k == "router" else v.to(dtype))
                  for k, v in params.items()}
        tokens = torch.from_numpy(case["tokens"]).to(dtype)
        run = moe.make_moe(sub, case["n_experts"],
                           dispatch=case["dispatch"],
                           capacity_factor=case["capacity_factor"])
        out = run(params, tokens)
        if case["dispatch"] == "all_to_all":
            out, dropped = out
            results.append({"out": out, "dropped": int(dropped)})
        else:
            results.append({"out": out})
    return results


def serving_pod_rank(mesh, prompts, demo_kw):
    """A pod of f32 servers over the mesh: rank 0 serves ``prompts``
    (greedy), then the demo burst with its mid-burst drain; then a second
    pod whose rank 1 was told to stop before its first round. Rank 0
    returns the tokens, the demo's summary and the second pod's; the
    others the rounds they served."""
    server = serving.build_server(mesh=mesh, param_dtype=torch.float32)
    stopped_event = threading.Event()
    if dist.get_rank() == 1:
        stopped_event.set()
    if dist.get_rank() != 0:
        served = server.serve()
        stopped = serving.build_server(mesh=mesh,
                                       param_dtype=torch.float32,
                                       stop_event=stopped_event)
        return {"served": served, "stopped_served": stopped.serve()}
    try:
        tokens = [server.handle(p) for p in prompts]
        summary = serving.run_demo(server, **demo_kw)
    finally:
        server.shutdown()
    stopped = serving.build_server(mesh=mesh, param_dtype=torch.float32,
                                   stop_event=stopped_event)
    refused = stopped.handle(prompts[0])
    stopped.shutdown()
    return {"tokens": tokens, "summary": summary,
            "stopped": {"refused": refused is None,
                        **stopped.summary()}}


def mesh_graph_decode_rank(mesh, case, config_kw, batch, prompt_len,
                           new_tokens):
    """One rank of the device decode against the host loop on the card
    (``case``: ``greedy_bf16``, ``greedy_int8_weights_int8_kv`` or
    ``sampled_int8_eos_logprobs``): both loops' tokens (and logprobs),
    this rank's device loop and its int8 kernel launches (and the decode
    kernels', the norm's, the gate's and the token pick's) over the device
    loop. Every rank
    draws the same bf16 weights and prompt."""
    from tpu_operator_libs_torch.kernels import WRAPPERS
    from tpu_operator_libs_torch.kernels.int8_matmul import int8_matmul

    device = mesh.device
    config = llama.LlamaConfig(**config_kw)
    int8 = "int8" in case
    params = llama.init_llama_params(config, param_dtype=torch.bfloat16,
                                     seed=1, mesh=mesh)
    if int8:
        params = llama_decode.quantize_params_int8(params, mesh)
    prompt = torch.randint(0, config.vocab, (batch, prompt_len),
                           device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(2))
    kw = {"param_dtype": torch.bfloat16, "quantize_kv": int8, "mesh": mesh}
    if case.startswith("sampled"):
        kw.update(temperature=1.0, top_k=50, top_p=0.9,
                  return_logprobs=True)
        free, _ = llama_decode.generate(
            params, prompt, config, new_tokens,
            generator=torch.Generator(device=device).manual_seed(3), **kw)
        kw["eos_id"] = int(free[0, prompt_len + 3])

    def run(fn):
        gen = (torch.Generator(device=device).manual_seed(3)
               if "temperature" in kw else None)
        return fn(params, prompt, config, new_tokens, generator=gen, **kw)

    host = run(llama_decode.generate)
    before = int8_matmul.launches
    decode_kernels = ("decode_attention", "rope_kv_append", "kv_append",
                      "rms_norm", "swiglu", "rope", "rope_bwd", "adamw",
                      "token_pick")
    before_decode = {name: WRAPPERS[name].launches for name in decode_kernels}
    dev = run(llama_decode.generate_on_device)
    torch.cuda.synchronize(device)
    out = {"device_loop": dict(llama_decode.generate_on_device.last_call),
           "int8_launches": int8_matmul.launches - before,
           "decode_launches": {name: WRAPPERS[name].launches
                               - before_decode[name]
                               for name in decode_kernels},
           "eos_id": kw.get("eos_id")}
    if "return_logprobs" in kw:
        (host, out["host_logprobs"]), (dev, out["device_logprobs"]) = \
            host, dev
    out.update(host=host, device=dev)
    return out


class _FakeGraph:
    """A CUDA graph's surface on the CPU: capture runs the step eagerly
    and a replay runs nothing, so the step's collectives are counted as
    they are on the card (the eager step and the capture, then the
    replays' carry)."""

    def register_generator_state(self, generator):
        pass

    def capture_begin(self, capture_error_mode):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


class _FakeStream:
    def __init__(self, *args, **kwargs):
        pass

    def wait_stream(self, other):
        pass

    def synchronize(self):
        pass


def _with_fake_graphs(fn):
    """``fn()`` with ``generate_on_device`` taking the card's path, its
    CUDA pieces faked; everything restored after."""
    import contextlib

    saved = [(llama_decode, "_captures"), (torch.cuda, "CUDAGraph"),
             (torch.cuda, "Stream"), (torch.cuda, "current_stream"),
             (torch.cuda, "stream")]
    saved = [(owner, name, getattr(owner, name)) for owner, name in saved]
    llama_decode._captures = lambda device, mesh: True
    torch.cuda.CUDAGraph = _FakeGraph
    torch.cuda.Stream = _FakeStream
    torch.cuda.current_stream = lambda device=None: _FakeStream()
    torch.cuda.stream = lambda stream: contextlib.nullcontext()
    try:
        return fn()
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)


def yi_tp4_rank(mesh, config_kw, dtype_name, seed, tokens_np, prompt_len,
                served, new_tokens):
    """A Yi-shaped model over a dp 1 x tp mesh, each rank's shards made
    one layer at a time from ``port_bench.weights``' seeded draws
    (``port_bench.tp_ranks.shard_model``), with an int8 cache:

    - ``logits``: the prefill of ``tokens_np[:, :prompt_len]`` through
      ``forward_with_cache``, then one step at each later position fed
      the given token: the whole (B, S - 1, vocab) logits on this rank;
    - ``forward_counts``: ``parallel.TP_COLLECTIVES``' (calls, bytes) of
      each of those forward calls;
    - ``eager`` / ``replayed``: ``generate_on_device.last_call`` of a
      greedy generation of ``new_tokens`` from the prompt, in the CPU's
      loop and on the card's path with its CUDA pieces faked;
    - ``served``: rank 0 serves each ``(prompt, seed)`` of ``served``
      through a ``DecodeServer`` over the mesh at temperature 1 (the
      tokens), the others follow (the rounds they took);
    - ``spans``: the pod's spans on this rank as (name, parent's name,
      is a root)."""
    from port_bench import tp_ranks
    from tpu_operator_libs_torch import tracing
    from tpu_operator_libs_torch.health.serving_gate import ServingEndpoint
    from tpu_operator_libs_torch.parallel import TP_COLLECTIVES

    dtype = getattr(torch, dtype_name)
    config = llama.LlamaConfig(**config_kw)
    params = tp_ranks.shard_model(config, seed, mesh, dtype)
    tokens = torch.from_numpy(tokens_np)
    batch, seq = tokens.shape
    cache = llama_decode.init_kv_cache(config, batch, seq, dtype,
                                       quantize_kv=True, mesh=mesh)
    parts, counts = [], []
    with torch.no_grad():
        calls = [(0, prompt_len)] + [(p, p + 1)
                                     for p in range(prompt_len, seq - 1)]
        for start, end in calls:
            before = (TP_COLLECTIVES.calls, TP_COLLECTIVES.bytes)
            logits, cache = llama_decode.forward_with_cache(
                params, tokens[:, start:end], cache, start, config, mesh)
            counts.append((TP_COLLECTIVES.calls - before[0],
                           TP_COLLECTIVES.bytes - before[1]))
            parts.append(logits.float())
    out = {"logits": torch.cat(parts, dim=1), "forward_counts": counts}

    def generate():
        llama_decode.generate_on_device(
            params, tokens[:, :prompt_len], config, new_tokens,
            param_dtype=dtype, quantize_kv=True, mesh=mesh)
        return dict(llama_decode.generate_on_device.last_call)

    out["eager"] = generate()
    out["replayed"] = _with_fake_graphs(generate)

    tracing.clear()
    server = serving.DecodeServer(
        config, params, ServingEndpoint("yi-tp4"),
        max_new_tokens=new_tokens, temperature=1.0, quantize_kv=True,
        mesh=mesh)
    if dist.get_rank() == 0:
        try:
            out["served"] = [server.handle(p, seed=s) for p, s in served]
        finally:
            server.shutdown()
    else:
        out["served"] = server.serve()
    found = tracing.records()
    by_id = {s.span_id: s for s in found}
    out["spans"] = [(s.name, by_id[s.parent_id].name
                     if s.parent_id in by_id else None,
                     s.parent_id is None and s.request_id == s.span_id)
                    for s in found]
    return out
