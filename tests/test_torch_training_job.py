"""The port's training job and checkpoint-durability gate on the CPU: the
contract of tests/test_training_job.py over the port's DCP layout —
the gate reads real checkpoints, a resumed run continues from the newest
commit bit for bit, and a stopped run loses only the steps since it."""

import os

import pytest
import torch

from tpu_operator_libs_torch.examples import training_job as job
from tpu_operator_libs_torch.examples.llama import make_token_batch
from tpu_operator_libs_torch.health.checkpoint_gate import (
    METADATA,
    CheckpointDurabilityGate,
    committed_steps,
    latest_committed_step,
)
from tpu_operator_libs_torch.optim import tree_leaves


def write_step(root, step, *names):
    path = root / str(step)
    path.mkdir(parents=True)
    for name in names:
        (path / name).write_bytes(b"x")
    return path


class TestGate:
    def test_closed_without_a_checkpoint(self, tmp_path):
        assert latest_committed_step(str(tmp_path / "absent")) is None
        assert latest_committed_step(str(tmp_path)) is None
        assert CheckpointDurabilityGate(str(tmp_path)).check() is False

    @pytest.mark.parametrize("names", [
        (), ("__0_0.distcp",), ("__0_0.distcp", ".metadata.tmp"),
    ], ids=["empty", "shards_only", "metadata_tmp"])
    def test_a_step_in_flight_is_not_committed(self, tmp_path, names):
        write_step(tmp_path, 4, *names)
        assert latest_committed_step(str(tmp_path)) is None
        assert CheckpointDurabilityGate(str(tmp_path)).check() is False

    def test_newest_committed_step_wins_over_newer_in_flight(self, tmp_path):
        write_step(tmp_path, 3, "__0_0.distcp", METADATA)
        write_step(tmp_path, 12, "__0_0.distcp", METADATA)
        write_step(tmp_path, 15, ".metadata.tmp")
        write_step(tmp_path, "notes")
        (tmp_path / "20").write_bytes(b"a file, not a step")
        assert committed_steps(str(tmp_path)) == [3, 12]
        assert latest_committed_step(str(tmp_path)) == 12
        gate = CheckpointDurabilityGate(str(tmp_path))
        assert gate.check() is True
        assert gate(node=None, pods=[]) is True  # eviction_gate signature

    def test_min_step(self, tmp_path):
        write_step(tmp_path, 8, METADATA)
        assert CheckpointDurabilityGate(str(tmp_path), min_step=8).check()
        assert not CheckpointDurabilityGate(str(tmp_path),
                                            min_step=9).check()

    def test_max_age_seconds(self, tmp_path):
        meta = write_step(tmp_path, 2, METADATA) / METADATA
        assert CheckpointDurabilityGate(str(tmp_path),
                                        max_age_seconds=60).check()
        old = meta.stat().st_mtime - 600
        os.utime(meta, (old, old))
        assert not CheckpointDurabilityGate(str(tmp_path),
                                            max_age_seconds=60).check()
        assert CheckpointDurabilityGate(str(tmp_path),
                                        max_age_seconds=0).check()


class TestGateReadsTheJobsCheckpoints:
    def test_committed_steps_visible(self, tmp_path):
        ckpt = str(tmp_path / "ckpt")
        assert CheckpointDurabilityGate(ckpt).check() is False
        result = job.train(ckpt, max_steps=6, save_interval=2, device="cpu")
        assert result["final_step"] == 6
        assert latest_committed_step(ckpt) == 6
        assert os.path.isfile(os.path.join(ckpt, "6", METADATA))
        assert CheckpointDurabilityGate(ckpt, min_step=6).check() is True
        assert CheckpointDurabilityGate(ckpt, min_step=7).check() is False

    def test_max_to_keep_prunes_the_oldest(self, tmp_path):
        ckpt = str(tmp_path / "ckpt")
        job.train(ckpt, max_steps=10, save_interval=2, device="cpu")
        assert committed_steps(ckpt) == [6, 8, 10]
        assert sorted(os.listdir(ckpt)) == ["10", "6", "8"]


class TestResume:
    @pytest.mark.parametrize("model", ["mlp", "llama"])
    def test_resumed_run_equals_uninterrupted_bit_for_bit(self, tmp_path,
                                                          model):
        ckpt = str(tmp_path / "ckpt")
        first = job.train(ckpt, max_steps=6, save_interval=3,
                          device="cpu", model=model)
        assert first["start_step"] == 0 and first["final_step"] == 6
        second = job.train(ckpt, max_steps=8, save_interval=3,
                           device="cpu", model=model)
        assert second["start_step"] == 6 and second["final_step"] == 8
        straight = job.train(str(tmp_path / "straight"), max_steps=8,
                             save_interval=4, device="cpu", model=model)
        assert straight["loss"] == second["loss"]

    def test_mid_interval_stop_loses_only_tail_steps(self, tmp_path):
        ckpt = str(tmp_path / "ckpt")
        calls = {"n": 0}

        def stop_flag():
            calls["n"] += 1
            return calls["n"] > 7  # allow steps 0..6

        result = job.train(ckpt, max_steps=100, save_interval=5,
                           device="cpu", stop_flag=stop_flag)
        assert result["final_step"] == 7
        assert latest_committed_step(ckpt) == 5
        resumed = job.train(ckpt, max_steps=10, save_interval=5,
                            device="cpu")
        assert resumed["start_step"] == 5  # lost exactly steps 6-7

    def test_restore_overwrites_every_tensor_of_the_state(self, tmp_path):
        state, step, config = job.init_state_llama("cpu")
        state, _ = step(state, make_token_batch(0, config, device="cpu"))
        manager = job.make_checkpoint_manager(str(tmp_path))
        manager.save(1, state)
        fresh, _, _ = job.init_state_llama("cpu")
        for t in tree_leaves(fresh):
            t.fill_(-1)
        restored, start = job.restore_state(manager, fresh)
        assert start == 1
        for a, b in zip(tree_leaves(state), tree_leaves(restored)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        with pytest.raises(ValueError, match="already committed"):
            manager.save(1, state)

    def test_schedule_and_clip_overrides_resume(self, tmp_path):
        overrides = {"warmup_steps": 2, "total_steps": 10,
                     "grad_clip_norm": 1.0}
        ckpt = str(tmp_path / "ckpt")
        job.train(ckpt, max_steps=3, save_interval=3, device="cpu",
                  model="llama", trainer_overrides=overrides)
        resumed = job.train(ckpt, max_steps=5, save_interval=5,
                            device="cpu", model="llama",
                            trainer_overrides=overrides)
        straight = job.train(str(tmp_path / "straight"), max_steps=5,
                             save_interval=5, device="cpu", model="llama",
                             trainer_overrides=overrides)
        assert resumed["start_step"] == 3
        assert resumed["loss"] == straight["loss"]


class TestEntryPoints:
    def test_main_trains_and_commits(self, tmp_path):
        ckpt = str(tmp_path / "ckpt")
        assert job.main(["--checkpoint-dir", ckpt, "--max-steps", "4",
                         "--save-interval", "2", "--device", "cpu",
                         "--model", "llama", "--grad-clip-norm", "1.0"]) == 0
        assert latest_committed_step(ckpt) == 4

    def test_main_refuses_more_than_one_device(self, tmp_path,
                                               monkeypatch):
        # more devices than there are cards, or fewer than one
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(SystemExit):
            job.main(["--checkpoint-dir", str(tmp_path), "--n-devices", "2"])
        with pytest.raises(SystemExit):
            job.main(["--checkpoint-dir", str(tmp_path), "--n-devices", "0",
                      "--device", "cpu"])

    def test_trains_on_every_visible_card_by_default(self, tmp_path,
                                                     monkeypatch):
        """The reference's ``make_mesh(None)`` takes every device: without
        ``n_devices`` the job asks for one rank per visible card (1 on the
        CPU, where the other tests train in this process)."""
        asked = []

        def fake_run_ranks(fn, n, *args, device=None, **kw):
            asked.append((fn, n, device.type))
            return [{"final_step": 1, "start_step": 0, "loss": 0.0}]

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        monkeypatch.setattr(job, "run_ranks", fake_run_ranks)
        assert job.train(str(tmp_path / "a"), max_steps=1)["final_step"] == 1
        assert job.main(["--checkpoint-dir", str(tmp_path / "b"),
                         "--max-steps", "1"]) == 0
        assert asked == [(job.train_rank, 4, "cuda")] * 2

    def test_bad_arguments(self, tmp_path):
        with pytest.raises(ValueError, match="unknown model"):
            job.train(str(tmp_path), device="cpu", model="gpt")
        with pytest.raises(ValueError, match="llama workload only"):
            job.train(str(tmp_path), device="cpu",
                      trainer_overrides={"total_steps": 5})
        with pytest.raises(ValueError, match="max_to_keep"):
            job.CheckpointManager(str(tmp_path), max_to_keep=0)

    def test_runs_on_the_card_by_default(self, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            job.train(str(tmp_path))
