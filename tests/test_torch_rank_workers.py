"""Rank functions for the port's multi-rank tests (``parallel.run_ranks``
starts them in fresh processes); the module holds no tests of its own.
It imports torch and the port, never jax: a child that imported a test module would import jax too, with
its platform plugin and XLA flags. Inputs arrive as numpy arrays and
plain values; results go back as numpy arrays.

Two of the functions break one collective on purpose, to show that the
tests would catch its absence: ``variant="no_copy_to_tp"`` drops the
all-reduce of ``copy_to_tp``'s backward, ``variant="local_clip"`` takes
the clip's norm over this rank's shards only, and
:func:`probe_with_a_corrupt_sender` makes rank 1 send a wrong tile.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from tpu_operator_libs_torch import optim
from tpu_operator_libs_torch.convert import shard_params
from tpu_operator_libs_torch.examples import llama, llama_decode
from tpu_operator_libs_torch.examples import training_job as job
from tpu_operator_libs_torch.health import fabric_probe
from tpu_operator_libs_torch.parallel import local_rows, mean_over_dp


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
    JAX's parameters cast to ``dtype_name``; and this rank's int8
    scales."""
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
    # sampling: every rank gets an equally seeded generator
    out["sampled"] = llama_decode.generate_on_device(
        params, prompt, config, new_tokens, param_dtype=dtype, mesh=mesh,
        temperature=1.0, top_k=8, generator=torch.Generator().manual_seed(0))
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
