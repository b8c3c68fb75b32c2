"""The port's GPipe pipeline and mixture of experts
(``tpu_operator_libs_torch/examples/pipeline.py``, ``moe.py``) on gloo
ranks against the JAX package's on the virtual CPU devices:
tests/test_pipeline_moe.py's cases at its 1e-6 (the pipeline against its
own layers run in order; against JAX's at PIPELINE_VS_JAX_TOL), with the
all-to-all dispatch's drop counts equal to JAX's exactly, from JAX's
parameters and inputs. Each rank count is one launch of ranks that runs
all of its cases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import test_torch_rank_workers as workers
from tpu_operator_libs.examples import moe as jmoe
from tpu_operator_libs.examples import pipeline as jpp
from tpu_operator_libs_torch.convert import (
    axis_block,
    stacked_params_from_jax,
)
from tpu_operator_libs_torch.examples import moe as tmoe
from tpu_operator_libs_torch.examples import pipeline as tpp
from tpu_operator_libs_torch.parallel import Mesh as RankMesh
from tpu_operator_libs_torch.parallel import run_ranks

#: tests/test_pipeline_moe.py's tolerances
TOL = 1e-6
BF16_TOL = 0.1
#: the pipeline's 2-8 layers against JAX's: XLA's CPU tanh is up to 3.8
#: ulp from the correctly rounded value (PyTorch's 0.57) and its dot
#: sums in another order (2.9e-6 apart on one (64, 16) x (16, 32)
#: product), so outputs of magnitude ~3 part by a few ulp a layer; the
#: port's pipeline against its own layers run in order holds TOL
PIPELINE_VS_JAX_TOL = 1e-5


def mesh_1d(n, name):
    return Mesh(np.array(jax.devices()[:n]), (name,))


def as_numpy(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def pipeline_case(pp, layers, d_model, d_hidden, x_shape):
    params = jpp.init_stage_params(jax.random.PRNGKey(0),
                                   n_layers_total=layers, d_model=d_model,
                                   d_hidden=d_hidden, pp=pp)
    x = jax.random.normal(jax.random.PRNGKey(1), x_shape)
    want = np.asarray(jpp.make_pipeline(mesh_1d(pp, "pp"))(params, x))
    return ({"kind": "pipeline", "params": as_numpy(params),
             "x": np.asarray(x)},
            {"want": want,
             "sequential": np.asarray(jpp.sequential_reference(params, x))})


def moe_case(ep, n_experts, n_tokens, d_model=16, d_hidden=32,
             dispatch="gather", capacity_factor=1.25, dtype="float32"):
    params = jmoe.init_moe_params(jax.random.PRNGKey(0),
                                  n_experts=n_experts, d_model=d_model,
                                  d_hidden=d_hidden)
    tokens = jax.random.normal(jax.random.PRNGKey(1), (n_tokens, d_model))
    if dtype == "bfloat16":
        tokens = tokens.astype(jnp.bfloat16)
        params = {k: v if k == "router" else v.astype(jnp.bfloat16)
                  for k, v in params.items()}
    out = jmoe.make_moe(mesh_1d(ep, "ep"), n_experts, dispatch=dispatch,
                        capacity_factor=capacity_factor)(params, tokens)
    expect = {"dense": np.asarray(jmoe.dense_reference(params, tokens),
                                  dtype=np.float32)}
    if dispatch == "all_to_all":
        out, dropped = out
        expect["dropped"] = int(dropped)
    expect["want"] = np.asarray(out, dtype=np.float32)
    params = {k: np.asarray(v, dtype=np.float32) for k, v in params.items()}
    return ({"kind": "moe", "params": params,
             "tokens": np.asarray(tokens, dtype=np.float32),
             "n_experts": n_experts, "dispatch": dispatch,
             "capacity_factor": capacity_factor, "dtype": dtype}, expect)


#: every case by name: (rank count, how to build it)
CASES = {
    "pp2": (2, lambda: pipeline_case(2, 8, 16, 32, (6, 4, 16))),
    "pp4": (4, lambda: pipeline_case(4, 8, 16, 32, (6, 4, 16))),
    "pp8": (8, lambda: pipeline_case(8, 8, 16, 32, (6, 4, 16))),
    "single_micro": (4, lambda: pipeline_case(4, 4, 8, 16, (1, 2, 8))),
    "more_micro": (2, lambda: pipeline_case(2, 2, 8, 16, (9, 2, 8))),
    "ep2_e4": (2, lambda: moe_case(2, 4, 8)),
    "ep4_e4": (4, lambda: moe_case(4, 4, 16)),
    "ep8_e16": (8, lambda: moe_case(8, 16, 32)),
    "a2a_generous": (4, lambda: moe_case(4, 4, 32, dispatch="all_to_all",
                                         capacity_factor=8.0)),
    "a2a_tight": (4, lambda: moe_case(4, 4, 32, dispatch="all_to_all",
                                      capacity_factor=0.25)),
    "a2a_bf16": (2, lambda: moe_case(2, 2, 600, 8, 16,
                                     dispatch="all_to_all",
                                     capacity_factor=4.0,
                                     dtype="bfloat16")),
}


@pytest.fixture(scope="module")
def built():
    """{case name: (the port's inputs, JAX's expectations)}."""
    return {name: build() for name, (_, build) in CASES.items()}


@pytest.fixture(scope="module")
def runs(built):
    """{case name: (the port's rank-0 result, JAX's expectations)}, one
    launch per rank count."""
    out = {}
    for n in sorted({n for n, _ in CASES.values()}):
        names = [name for name, (m, _) in CASES.items() if m == n]
        ranks = run_ranks(workers.pipeline_moe_rank, n,
                          [built[name][0] for name in names], device="cpu",
                          mesh_shape={"pp": n})
        for i, name in enumerate(names):
            for rank in ranks[1:]:  # every rank returns the whole output
                np.testing.assert_array_equal(rank[i]["out"],
                                              ranks[0][i]["out"])
            out[name] = (ranks[0][i], built[name][1])
    return out


class TestPipeline:
    @pytest.mark.parametrize("name", ["pp2", "pp4", "pp8", "single_micro",
                                      "more_micro"])
    def test_matches_sequential_and_jax(self, runs, built, name):
        got, expect = runs[name]
        case, _ = built[name]
        sequential = tpp.sequential_reference(
            stacked_params_from_jax(case["params"], device="cpu"),
            torch.tensor(case["x"]))
        np.testing.assert_allclose(got["out"], sequential.numpy(),
                                   rtol=TOL, atol=TOL)
        for want in (expect["want"], expect["sequential"]):
            np.testing.assert_allclose(got["out"], want,
                                       rtol=PIPELINE_VS_JAX_TOL,
                                       atol=PIPELINE_VS_JAX_TOL)

    def test_layers_must_divide_stages(self):
        with pytest.raises(ValueError, match="must divide"):
            tpp.init_stage_params(6, 8, 16, 4, device="cpu")

    def test_a_rank_keeps_its_stage_of_layers(self, built):
        case, _ = built["pp4"]
        mesh = RankMesh(dp=1, tp=1, dp_rank=0, tp_rank=0, dp_group=None,
                        tp_group=None, device=torch.device("cpu"),
                        axis_names=("pp",), other={"pp": (4, 2, None)})
        block = axis_block(stacked_params_from_jax(case["params"],
                                                   device="cpu"), mesh, "pp")
        np.testing.assert_array_equal(block["w1"].numpy(),
                                      case["params"]["w1"][4:6])
        np.testing.assert_array_equal(block["w2"].numpy(),
                                      case["params"]["w2"][4:6])


class TestMoE:
    @pytest.mark.parametrize("name", ["ep2_e4", "ep4_e4", "ep8_e16"])
    def test_matches_jax_and_dense(self, runs, name):
        got, expect = runs[name]
        np.testing.assert_allclose(got["out"], expect["want"], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got["out"], expect["dense"], rtol=TOL,
                                   atol=TOL)

    def test_every_expert_exercised(self):
        params = jmoe.init_moe_params(jax.random.PRNGKey(0), n_experts=4,
                                      d_model=16, d_hidden=32)
        tokens = jax.random.normal(jax.random.PRNGKey(1), (64, 16))
        jchoice, jgate = jmoe._route(tokens, params["router"])
        choice, gate = tmoe._route(torch.from_numpy(np.asarray(tokens)),
                                   torch.from_numpy(
                                       np.asarray(params["router"])))
        assert set(choice.tolist()) == {0, 1, 2, 3}
        np.testing.assert_array_equal(choice.numpy(), np.asarray(jchoice))
        np.testing.assert_allclose(gate.numpy(), np.asarray(jgate),
                                   rtol=TOL, atol=TOL)
        assert float(gate.min()) > 0.0

    def test_all_to_all_matches_dense_with_generous_capacity(self, runs):
        got, expect = runs["a2a_generous"]
        assert got["dropped"] == expect["dropped"] == 0
        np.testing.assert_allclose(got["out"], expect["dense"], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got["out"], expect["want"], rtol=TOL,
                                   atol=TOL)

    def test_all_to_all_drop_accounting_is_exact(self, runs):
        got, expect = runs["a2a_tight"]
        out = got["out"]
        assert got["dropped"] == expect["dropped"] > 0
        zero_rows = int((np.abs(out).sum(axis=1) == 0).sum())
        kept = int((np.abs(out - expect["dense"]).max(axis=1) < 1e-5).sum())
        assert zero_rows == got["dropped"]
        assert kept + zero_rows >= len(out)
        np.testing.assert_allclose(out, expect["want"], rtol=TOL, atol=TOL)

    def test_capacity_reference_counts_what_jax_drops(self, built):
        """The plain version of the capacity rule (the card's oracle)
        drops the tokens JAX drops."""
        case, expect = built["a2a_tight"]
        params = stacked_params_from_jax(case["params"], device="cpu")
        out, dropped = tmoe.capacity_reference(
            params, torch.from_numpy(case["tokens"]), 4, 0.25)
        assert dropped == expect["dropped"]
        np.testing.assert_allclose(out.numpy(), expect["want"], rtol=TOL,
                                   atol=TOL)

    def test_all_to_all_bf16_tokens_no_slot_collisions(self, runs):
        got, expect = runs["a2a_bf16"]
        assert got["dropped"] == expect["dropped"] == 0
        np.testing.assert_allclose(got["out"], expect["dense"],
                                   rtol=BF16_TOL, atol=BF16_TOL)

    def test_unknown_dispatch_rejected(self):
        mesh = RankMesh(dp=1, tp=1, dp_rank=0, tp_rank=0, dp_group=None,
                        tp_group=None, device=torch.device("cpu"),
                        axis_names=("ep",), other={"ep": (2, 0, None)})
        with pytest.raises(ValueError, match="dispatch"):
            tmoe.make_moe(mesh, 4, dispatch="scatter")

    def test_experts_must_divide_shards(self):
        mesh = RankMesh(dp=1, tp=1, dp_rank=0, tp_rank=0, dp_group=None,
                        tp_group=None, device=torch.device("cpu"),
                        axis_names=("ep",), other={"ep": (8, 0, None)})
        with pytest.raises(ValueError, match="must divide"):
            tmoe.make_moe(mesh, n_experts=6)

    def test_gate_scales_output(self):
        params = tmoe.init_moe_params(4, 16, 32, device="cpu")
        tokens = torch.randn(8, 16, generator=torch.Generator().manual_seed(1))
        out1 = tmoe.dense_reference(params, tokens)
        out2 = tmoe.dense_reference(dict(params, router=params["router"] * 8),
                                    tokens)
        assert not torch.allclose(out1, out2)
