"""The port's multi-device entry (``multichip.py``, the counterpart of
``__graft_entry__.py``) and the multi-rank training job on gloo ranks:
the dry run's stages, a 4-rank job that saves, opens the gate and resumes
bit for bit, and a tp=2 checkpoint whose every shard comes back."""

import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_rank_workers as workers
from tpu_operator_libs_torch import kernels, multichip
from tpu_operator_libs_torch.examples import training_job as job
from tpu_operator_libs_torch.health.checkpoint_gate import (
    CheckpointDurabilityGate,
    latest_committed_step,
)
from tpu_operator_libs_torch.parallel import dp_tp_split, run_ranks


@pytest.mark.parametrize("n,split", [(1, (1, 1)), (2, (1, 2)), (4, (2, 2)),
                                     (6, (2, 3)), (8, (2, 4)), (9, (3, 3))])
def test_dp_tp_split_is_the_reference_rule(n, split):
    assert dp_tp_split(n) == split


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    results = multichip.dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip OK: stages train, decode, checkpoint, fabric" \
        in out and "dp=2 tp=2" in out
    assert multichip.STAGES == ("train", "decode", "checkpoint", "fabric",
                                "ring", "pipeline", "moe")
    assert "fabric, ring, pipeline, moe;" in out
    assert "not ported" not in out
    assert len(results) == 4
    for rank in results:
        assert (rank["dp"], rank["tp"]) == (2, 2)
        assert np.isfinite(rank["losses"]).all()
        assert rank["losses"] == results[0]["losses"]
        assert [f["healthy"] for f in rank["fabric"]] == [True] * 3
        assert rank["bandwidth"]["n_devices"] == 4
        np.testing.assert_array_equal(rank["decode_plain"],
                                      results[0]["decode_plain"])
        assert rank["decode_plain"].shape == (4, 8)
        assert rank["launches"] == {name: 0 for name in
                                    multichip.WRAPPERS}  # xla path
        # __graft_entry__.py's shapes, ring at head_dim 16, within 1e-4
        assert rank["ring"]["shape"] == [2, 32, 2, 16]
        assert rank["pipeline"]["layers"] == 8
        assert rank["moe"]["experts"] == 8
        for err in (rank["ring"]["max_abs_err"],
                    rank["pipeline"]["max_abs_err"],
                    rank["moe"]["gather"]["max_abs_err"],
                    rank["moe"]["all_to_all"]["max_abs_err"]):
            assert err <= multichip.PARALLEL_TOL
        a2a = rank["moe"]["all_to_all"]
        assert a2a["dropped"] == a2a["plain_dropped"]


def test_entry_runs_on_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multichip.entry()


def test_training_job_on_four_ranks_saves_gates_and_resumes_bit_equal(
        tmp_path):
    ckpt = str(tmp_path / "ckpt")
    gate = CheckpointDurabilityGate(ckpt)
    assert not gate.check()
    assert job.main(["--checkpoint-dir", ckpt, "--max-steps", "2",
                     "--save-interval", "2", "--n-devices", "4",
                     "--device", "cpu", "--model", "llama"]) == 0
    assert gate.check() and latest_committed_step(ckpt) == 2
    resumed = job.train(ckpt, max_steps=3, save_interval=3, device="cpu",
                        model="llama", n_devices=4)
    straight = job.train(str(tmp_path / "straight"), max_steps=3,
                         save_interval=3, device="cpu", model="llama",
                         n_devices=4)
    assert resumed["start_step"] == 2 and resumed["final_step"] == 3
    assert straight["start_step"] == 0
    assert resumed["loss"] == straight["loss"]


def test_checkpoint_at_tp2_restores_every_shard(tmp_path):
    ranks = run_ranks(workers.checkpoint_shards_rank, 2, str(tmp_path),
                      device="cpu")
    for tp_rank, rank in enumerate(ranks):
        assert rank["start"] == 1
        assert rank["differed_before"] > 0
        assert rank["equal"] == rank["leaves"], rank
        assert rank["wq_shape"][1] * 2 == 64  # a shard, not the whole
    keys = ranks[0]["keys"]
    assert keys == ranks[1]["keys"]
    for tp_rank in (0, 1):
        for prefix in ("params.layers.0.wq", "opt.mu.lm_head",
                       "opt.nu.layers.1.w_down"):
            assert f"{prefix}@tp{tp_rank}" in keys
    assert "params.embed" in keys  # replicated: one copy, its own key


def test_restore_launches_sets_counts_and_designs_back():
    """A yardstick run between save_launches and restore_launches (as the
    ring Llama's flash forward is) leaves no trace in either count: the
    ring stage's launches by design must add up to its launches."""
    wrapper = kernels.WRAPPERS["flash_attention_fwd"]
    saved = kernels.save_launches()
    wrapper.launches += 4
    wrapper.launches_by_design["sm90 wgmma"] = \
        wrapper.launches_by_design.get("sm90 wgmma", 0) + 4
    kernels.restore_launches(saved)
    assert kernels.save_launches() == saved
    assert (multichip._launches(), multichip._launches_by_design()) == saved


def causal_ring_rank(r, designs=None):
    """A rank's launches of the card's multi-rank phase at sp = 4: rank r
    of a causal ring runs r + 1 blocks a layer forward and backward."""
    blocks = 2 * (r + 1)
    return {"launches": {"flash_attention_fwd": 0},
            "launches_by_design": {"flash_attention_fwd": {}},
            "launches_ring": {"flash_attention_fwd": blocks,
                              "flash_attention_bwd_dq": blocks},
            "launches_by_design_ring": designs or {
                "flash_attention_fwd": {"sm90 wgmma": blocks},
                "flash_attention_bwd_dq": {"sm90 wgmma": blocks - 1,
                                           "3xTF32 mma.sync": 1}}}


def test_a_causal_rings_ranks_may_launch_different_counts():
    """Phase 9 at four cards: the ranks of a causal ring run different
    numbers of blocks, so their launches by design differ; each rank's
    designs must add up to its own launches."""
    chip_smoke.check_rank_designs([causal_ring_rank(r) for r in range(4)])
    short = causal_ring_rank(2, {"flash_attention_fwd": {"sm90 wgmma": 5}})
    with pytest.raises(RuntimeError, match="rank 2's flash_attention_fwd"):
        chip_smoke.check_rank_designs(
            [causal_ring_rank(0), causal_ring_rank(1), short])
