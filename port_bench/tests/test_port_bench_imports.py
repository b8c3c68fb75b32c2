"""What a run loads: the harness, its drivers, readers and reference
import no module whose top-level name is jax, jaxlib, flax or
tpu_operator_libs (compared whole: the port, tpu_operator_libs_torch,
is allowed); the reference imports nothing of the port either."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

HARNESS = """
import json, sys
sys.path.insert(0, {root!r})
from port_bench import harness, run, calibrate
bench = harness.benchmark()
for cell in bench["workloads"]:
    data = harness.load_json("workloads", cell["name"])
    harness.load_module("drivers", data["driver"])
    harness.llama_config(harness.load_json("configs", data["config"]))
for m in bench["per_layer"]:
    harness.load_module("metrics", m["name"])
import tpu_operator_libs_torch.examples.llama_decode
import tpu_operator_libs_torch.examples.llama_serving_job
print(json.dumps(sorted(sys.modules)))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
from port_bench import weights, rooflines
from port_bench.reference import llama_f32
print(json.dumps(sorted(sys.modules)))
"""


def loaded(code: str) -> "set[str]":
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=240,
                         check=True, cwd=ROOT)
    return {name.split(".")[0] for name in json.loads(out.stdout)}


def test_the_harness_loads_no_jax_and_no_jax_package():
    tops = loaded(HARNESS)
    assert "tpu_operator_libs_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "tpu_operator_libs"}


def test_the_reference_loads_nothing_of_the_program():
    tops = loaded(REFERENCE)
    assert "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "tpu_operator_libs",
                       "tpu_operator_libs_torch"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    from port_bench import harness

    monkeypatch.setitem(sys.modules, "tpu_operator_libs_torch_x", sys)
    assert "tpu_operator_libs_torch_x" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in harness.forbidden_loaded()
