"""Without a card the run exits non-zero and prints no result: it never
falls back to the CPU. In a directory that holds only BENCHMARK.json and
the benchmark's own files (no program) it fails the same way."""

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "serve.ds7b-w8kv8.chat", "--seed", "2147483999",
        "--seconds", "1", "--trace", "0"]


def run(cwd: Path, env_extra=None):
    import os

    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env_extra or {})}
    return subprocess.run([sys.executable, "port_bench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=240, env=env)


def test_no_card_no_result():
    out = run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
