"""The port's tensor-parallel decode of a Yi-shaped model at tp 4 on four
gloo ranks, against the benchmark's plain float32 reference
(``port_bench/reference/served_grids.py``: the weights as drawn, the KV
cache on the int8 grid).

The model has Yi-34B's block and its 7:1 grouped-query ratio at a small
width (d_model 448, 28 query heads over 4 KV heads of 16, FFN 640,
vocab 512, 3 layers, ``rope_theta`` 5e6), so that each rank holds 7
query heads over one KV head, as each card of the benchmark's pod does.
Every rank makes the weights one layer at a time from
``port_bench.weights``' seeded draws and keeps its shards
(``port_bench.tp_ranks.shard_model``), with an int8 cache:

- the prefill and each decode step through ``forward_with_cache`` give
  the whole logits on every rank, within a tolerance of the reference's
  full forward pass, in float32 and in bfloat16;
- the tokens a ``DecodeServer`` over the mesh samples from a seed are
  judged by the reference's Gumbel scores, as the benchmark judges them
  (tokens are not compared with a one-rank server's: the tp sum's order
  may flip a near tie);
- ``parallel.TP_COLLECTIVES`` counts 2 x layers + 1 collectives a
  forward call with their bytes, in the CPU's loop and on the card's
  path with its CUDA pieces faked;
- the pod's ``serve.round`` and ``serve.follow`` spans have their
  parents.
"""

import dataclasses

import numpy as np
import pytest
import torch

import test_torch_rank_workers as workers
from port_bench import weights
from port_bench.reference import llama_f32, served_grids
from tpu_operator_libs_torch.convert import shard_params
from tpu_operator_libs_torch.examples.llama import LlamaConfig
from tpu_operator_libs_torch.kernels.rms_norm import EPS
from tpu_operator_libs_torch.parallel import Mesh, run_ranks

CONFIG = LlamaConfig(vocab=512, d_model=448, n_layers=3, n_heads=28,
                     n_kv_heads=4, d_ff=640, seq_len=64, rope_theta=5e6)
TP = 4
BATCH, PROMPT, SEQ, NEW = 4, 12, 20, 6
#: a seed whose float32 run flips an int8 code of the cache (below)
SEED = 5

#: float32: the ranks' partial sums agree with the reference to ~4e-6
#: (seeds 1-4); where a key or value lies on a rounding edge of the
#: int8 grid in one and not in the other it moves by one code step, a
#: 127th of its row's largest, which moved the logits by up to 3.9e-3
#: (seeds 5-7). 0.02 is five times that, and half of what an unquantized
#: (float32) cache moves them (0.040-0.050, seeds 1-3).
F32_TOL = 0.02
#: bfloat16: every product's output and the residual rounded to 8 bits
#: of mantissa through 3 layers: 0.068-0.099 over seeds 4-7, on logits
#: up to 4.8. 0.15 is half again over that; an int4 cache moves them
#: 0.75-0.96 and int4 weights 1.9-2.4 (seeds 1-3).
BF16_TOL = 0.15
TOL = {"float32": F32_TOL, "bfloat16": BF16_TOL}


def tokens(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CONFIG.vocab, (BATCH, SEQ))


def served():
    rng = np.random.default_rng(1)
    return [(rng.integers(0, CONFIG.vocab, (BATCH, 9)), 2147483999 + i)
            for i in range(2)]


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pod(request):
    dtype = request.param
    ranks = run_ranks(workers.yi_tp4_rank, TP, dataclasses.asdict(CONFIG),
                      dtype, SEED, tokens(), PROMPT, served(), NEW,
                      device="cpu", mesh_shape={"dp": 1, "tp": TP})
    return dtype, ranks


def reference(dtype, toks, first=0, weight_bits=None, kv_bits=8):
    llama_f32.no_tf32()
    dt = getattr(torch, dtype)
    ends = weights.make_ends(CONFIG, SEED, "cpu", dt)
    with torch.no_grad():
        return served_grids.served_logits(
            CONFIG, EPS, torch.as_tensor(toks), first,
            lambda i: weights.make_layer(CONFIG, SEED, i, "cpu", dt), ends,
            weight_bits=weight_bits, kv_bits=kv_bits).numpy()


def test_prefill_and_steps_give_the_references_logits_on_every_rank(pod):
    dtype, ranks = pod
    want = reference(dtype, tokens())
    assert ranks[0]["logits"].shape == want.shape == (
        BATCH, SEQ - 1, CONFIG.vocab)
    for rank in ranks:  # whole logits on every rank, the same
        np.testing.assert_array_equal(rank["logits"], ranks[0]["logits"])
    gap = np.abs(ranks[0]["logits"] - want).max()
    assert gap <= TOL[dtype], gap
    # the tolerance tells the stated grids from a lower precision: the
    # reference with an int4 cache lies outside it
    low = reference(dtype, tokens(), kv_bits=4)
    assert np.abs(low - want).max() > TOL[dtype]


def test_float32_tolerance_tells_an_unquantized_cache_apart():
    want = reference("float32", tokens())
    unquantized = reference("float32", tokens(), kv_bits=None)
    assert np.abs(unquantized - want).max() > F32_TOL


def test_served_tokens_pass_the_references_gumbel_judgement(pod):
    """A served token's score can lie below the reference's best by at
    most twice the largest logit difference over the temperature (its
    own score low by it, the best one's high by it): the tolerance of
    the logits, doubled, at temperature 1."""
    dtype, ranks = pod
    for (prompt, seed), out in zip(served(), ranks[0]["served"]):
        assert out.shape == (BATCH, prompt.shape[1] + NEW)
        np.testing.assert_array_equal(out[:, :prompt.shape[1]], prompt)
        first = prompt.shape[1] - 1
        noise = llama_f32.pick_noise(seed, BATCH, CONFIG.vocab, NEW, "cpu",
                                     1.0)
        scores = llama_f32.pick_scores(
            torch.from_numpy(reference(dtype, out, first)), noise, 1.0)
        gap = llama_f32.token_gaps(
            scores, torch.from_numpy(out[:, first + 1:])).max().item()
        assert gap <= 2 * TOL[dtype], gap
    assert [r["served"] for r in ranks[1:]] == [len(served())] * (TP - 1)


def per_forward(dtype, rows):
    """(collectives, bytes) of one forward call over ``rows`` positions:
    two all-reduces of the residual a layer and the vocabulary's
    gather."""
    size = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    return (2 * CONFIG.n_layers + 1,
            size * rows * (2 * CONFIG.n_layers * CONFIG.d_model
                           + CONFIG.vocab))


def test_the_collectives_of_each_forward_call_are_counted(pod):
    dtype, ranks = pod
    prefill = per_forward(dtype, BATCH * PROMPT)
    step = per_forward(dtype, BATCH)
    for rank in ranks:
        counts = [tuple(c) for c in rank["forward_counts"]]
        assert counts == [prefill] + [step] * (SEQ - 1 - PROMPT)


@pytest.mark.parametrize("loop", ["eager", "replayed"])
def test_a_generations_collectives_count_every_step(pod, loop):
    """``last_call`` of a greedy generation of NEW tokens: the prefill
    and NEW - 1 steps, on the CPU's loop and through ``_replay_steps``
    (an eager step, the capture, the replays' carry)."""
    dtype, ranks = pod
    calls, prefill = per_forward(dtype, BATCH * PROMPT)
    _, step = per_forward(dtype, BATCH)
    for rank in ranks:
        record = rank[loop]
        assert record["collectives"] == NEW * calls
        assert record["collective_bytes"] == prefill + (NEW - 1) * step
        assert record["graph_launches"] == (NEW - 2 if loop == "replayed"
                                            else 0)


def test_the_pods_round_spans_have_their_parents(pod):
    _, ranks = pod
    lead = set(map(tuple, ranks[0]["spans"]))
    # rank 0: each request's round under its serve.request, the
    # generation inside the round; the closing stop round a root
    assert ("serve.round", "serve.request", False) in lead
    assert ("decode.generate", "serve.round", False) in lead
    assert ("serve.round", None, True) in lead
    assert not any(name == "serve.follow" for name, _, _ in lead)
    for rank in ranks[1:]:
        spans = [tuple(s) for s in rank["spans"]]
        # one root a follower, every round under it, each generation
        # inside its round
        assert spans.count(("serve.follow", None, True)) == 1
        rounds = [s for s in spans if s[0] == "serve.round"]
        assert rounds == [("serve.round", "serve.follow", False)] * (
            len(served()) + 1)
        generations = [s for s in spans if s[0] == "decode.generate"]
        assert generations == [("decode.generate", "serve.round",
                                False)] * len(served())


def rank_mesh(rank):
    return Mesh(dp=1, tp=TP, dp_rank=0, tp_rank=rank, dp_group=None,
                tp_group=None, device=torch.device("cpu"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_ranks_shards_of_a_layer_make_the_whole_layer(dtype):
    """The four ranks' ``shard_params`` shards of one ``make_layer`` layer,
    put back together on their split dims, are the whole layer; the
    replicated norms are whole on every rank. Each shard holds storage of
    its own, the size of its block: a view would keep the whole layer's
    draw alive after the caller frees it (with 60 layers, the whole
    model on every card)."""
    layer = weights.make_layer(CONFIG, SEED, 1, "cpu", dtype)
    shards = [shard_params(layer, rank_mesh(r)) for r in range(TP)]
    split = {"wq": 1, "wk": 1, "wv": 1, "w_gate": 1, "w_up": 1, "wo": 0,
             "w_down": 0}
    for name, whole in layer.items():
        if name in split:
            parts = [s[name] for s in shards]
            assert torch.equal(torch.cat(parts, dim=split[name]), whole)
            for part in parts:
                assert part.untyped_storage().nbytes() == \
                    part.numel() * part.element_size()
        else:
            for s in shards:
                assert torch.equal(s[name], whole)
    assert shards[0]["wq"].shape == (CONFIG.d_model, 7 * CONFIG.head_dim)
    assert shards[0]["wk"].shape == (CONFIG.d_model, CONFIG.head_dim)
