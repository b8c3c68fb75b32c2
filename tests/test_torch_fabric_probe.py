"""The port's fabric probe on gloo ranks against the JAX package's ICI
probe on the virtual CPU devices, and its validator behind the JAX
package's ``ValidationManager`` seam on a ``FakeCluster`` GPU node.

Every multi-rank run starts fresh processes (``parallel.run_ranks``); the
functions they run live in the port or in ``test_torch_rank_workers``, which
imports no jax."""

import logging

import numpy as np
import pytest
import torch

import test_torch_rank_workers as workers
from builders import DaemonSetBuilder, NodeBuilder, PodBuilder
from helpers import make_env, make_state_manager
from tpu_operator_libs.consts import UpgradeKeys, UpgradeState
from tpu_operator_libs.health import ici_probe
from tpu_operator_libs.util import FakeClock
from tpu_operator_libs_torch.health import fabric_probe as fp
from tpu_operator_libs_torch.parallel import run_ranks

#: bf16 inputs, f32 sums on both sides; tanh in f32: one bf16 ulp of the
#: output, as tests/test_health.py holds the JAX probe (atol 1e-2)
SINGLE_CHIP_ATOL = 1e-2
NS = "gpu-operator"
DRIVER_LABELS = {"app": "nvidia-driver"}
GPU_KEYS = UpgradeKeys(driver="gpu", domain="nvidia.com")


@pytest.fixture(scope="module")
def corrupt_probe():
    """The node probe while rank 1 of 2 sends wrong tiles."""
    return run_ranks(workers.probe_with_a_corrupt_sender, 2, device="cpu")


class TestBattery:
    @pytest.mark.parametrize("n", [1, 2, 4])
    def test_healthy_with_zero_error_as_jax(self, n):
        ranks = run_ranks(fp.fabric_probe_rings, n, device="cpu")
        shifts = [r.shift for r in ranks[0]]
        assert shifts == (list(range(1, n)) or [1])
        for results in ranks:
            for r in results:
                assert r.healthy and r.max_abs_error == 0.0, str(r)
                assert r.n_devices == n and r.latency_s > 0
        # every rank reports the one (slowest) latency
        assert len({tuple(r.latency_s for r in rs) for rs in ranks}) == 1
        jax_result = ici_probe.fabric_probe(n_devices=n)
        assert jax_result.healthy and jax_result.max_abs_error == 0.0

    def test_a_rank_sending_a_wrong_value_fails_the_probe(self,
                                                          corrupt_probe):
        for rank in corrupt_probe:
            assert not rank["healthy"]
            assert rank["max_abs_error"] == pytest.approx(1.0)


def test_single_chip_probe_matches_jax():
    fn, args = fp.single_chip_probe(device="cpu")
    jfn, jargs = ici_probe.single_chip_probe()
    assert args[0].dtype == torch.bfloat16 and args[1].dtype == torch.bfloat16
    np.testing.assert_array_equal(args[0].float().numpy(),
                                  np.asarray(jargs[0], np.float32))
    out = fn(*args)
    assert out.shape == (128, 128) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jfn(*jargs)),
                               atol=SINGLE_CHIP_ATOL)
    np.testing.assert_allclose(out.numpy(), np.tanh(0.5) + 0.25,
                               atol=SINGLE_CHIP_ATOL)


class TestBandwidth:
    def test_structure(self):
        ranks = run_ranks(fp.fabric_bandwidth_probe, 2, 1, 2, 1e-9,
                          device="cpu")
        for r in ranks:
            assert r.n_devices == 2 and r.rounds == 2
            assert r.bytes_per_hop == 1 << 20
            assert r.latency_s > 0 and r.gbytes_per_s >= 0
            assert r.gbytes_per_s == round(r.gbytes_per_s, 2)
            assert r.healthy
        assert ranks[0].gbytes_per_s == ranks[1].gbytes_per_s

    def test_refuses_one_rank(self):
        with pytest.raises(RuntimeError, match="needs >= 2 devices"):
            run_ranks(fp.fabric_bandwidth_probe, 1, 1, 1, device="cpu")


class TestShiftedRings:
    @pytest.mark.parametrize("n", [2, 3, 4, 8])
    def test_cover_every_ordered_pair_once(self, n):
        pairs = [pair for shift in fp.shifted_rings(n)
                 for pair in fp.ring_pairs(n, shift)]
        expected = {(i, j) for i in range(n) for j in range(n) if i != j}
        assert sorted(pairs) == sorted(expected)

    def test_one_device_has_no_ring(self):
        assert fp.shifted_rings(1) == []

    def test_cap_is_logged(self, caplog):
        with caplog.at_level(logging.WARNING):
            assert fp.shifted_rings(8, max_rings=2) == [1, 2]
        assert "5 of 7 shifted rings not probed" in caplog.text


def gpu_node(name, product="NVIDIA-H100-80GB-HBM3"):
    return NodeBuilder(name).with_labels(
        {fp.GPU_PRODUCT_LABEL: product}).build()


class TestValidator:
    def test_cache_is_keyed_per_node_and_product(self):
        calls = []
        clock = FakeClock()
        validator = fp.FabricValidator(
            probe_runner=lambda: calls.append(1) or True,
            cache_seconds=100, clock=clock)
        a, b = gpu_node("a"), gpu_node("b")
        a_other = gpu_node("a", product="NVIDIA-A100")
        assert validator(a) and validator(a) and validator(b)
        assert len(calls) == 2  # a cached; b probed apart
        assert validator(a_other) and len(calls) == 3
        clock.advance(101)
        assert validator(a) and len(calls) == 4  # expired

    def test_runner_result_with_healthy_field(self):
        validator = fp.FabricValidator(
            probe_runner=lambda: fp.FabricProbeResult(False, 1.0, 0.1, 2))
        assert validator(gpu_node("a")) is False

    def test_bandwidth_floor_gates_health(self):
        validator = fp.FabricValidator(cache_seconds=0, device="cpu",
                                       n_devices=2,
                                       min_bandwidth_gbytes_per_s=1e12)
        assert validator(gpu_node("a")) is False

    def test_floor_on_one_device_warns_and_skips(self, caplog):
        validator = fp.FabricValidator(cache_seconds=0, device="cpu",
                                       n_devices=1,
                                       min_bandwidth_gbytes_per_s=1e12)
        with caplog.at_level(logging.WARNING):
            assert validator(gpu_node("a")) is True
        assert "skipping the throughput gate" in caplog.text

    def test_default_probe_runs_on_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fp.FabricValidator()(gpu_node("a"))


def test_validation_manager_holds_the_node_until_the_probe_passes(
        corrupt_probe):
    """The port's validator in the JAX package's upgrade flow: a GPU node
    in validation-required stays there while rank 1's link corrupts the
    probe, and moves on once the probe passes on every rank."""
    env = make_env(GPU_KEYS)
    ds = DaemonSetBuilder("nvidia-driver", namespace=NS) \
        .with_labels(dict(DRIVER_LABELS)) \
        .with_desired_scheduled(1).with_revision_hash("rev1") \
        .create(env.cluster)
    node = NodeBuilder("gpu-0").with_labels(
        {fp.GPU_PRODUCT_LABEL: "NVIDIA-H100-80GB-HBM3"}) \
        .with_upgrade_state(env.keys, UpgradeState.VALIDATION_REQUIRED) \
        .create(env.cluster)
    PodBuilder("nvidia-driver-0", namespace=NS).on_node(node).owned_by(ds) \
        .with_revision_hash("rev1").ready().create(env.cluster)
    healthy_probe = fp.FabricValidator(device="cpu", n_devices=2,
                                       min_bandwidth_gbytes_per_s=1e-9)
    runner = {"probe": lambda: corrupt_probe[0]["healthy"], "calls": 0}

    def probe():
        runner["calls"] += 1
        return runner["probe"]()

    validator = fp.FabricValidator(probe_runner=probe, cache_seconds=60,
                                   clock=env.clock)
    mgr = make_state_manager(env).with_validation_enabled(
        extra_validator=validator)

    def reconcile():
        mgr.process_validation_required_nodes(
            mgr.build_state(NS, DRIVER_LABELS))
        return env.state_of("gpu-0")

    assert reconcile() == "validation-required"
    assert runner["calls"] == 1
    runner["probe"] = lambda: healthy_probe(env.cluster.get_node("gpu-0"))
    assert reconcile() == "validation-required"  # cached failure holds
    assert runner["calls"] == 1
    env.clock.advance(61)
    assert reconcile() == "uncordon-required"
    assert runner["calls"] == 2
    # the reference's GPU key scheme (consts.py:447-453)
    assert GPU_KEYS.state_label == "nvidia.com/gpu-upgrade-state"
