"""What the benchmark imports, and how a run ends where it cannot run:
no JAX, no JAX package (compared by whole top-level name, so the port,
``repro_torch``, passes), and a reference that imports nothing of the
program either."""
import os
import re
import subprocess
import sys

import pytest

from .tiny import REPO, copy_benchmark

BANNED = {"jax", "jaxlib", "flax", "repro"}

_PROBE = """
import importlib, json, sys
from pathlib import Path
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
from chipbench.harness import bench
mods = sys.argv[2:]
for name in mods:
    importlib.import_module(name)
root = Path(sys.argv[1])
for p in sorted((root / "chipbench" / "metrics").glob("*.py")) + \\
        sorted((root / "chipbench" / "drivers").glob("*.py")):
    if not mods or mods[0] != "chipbench.reference.model":
        bench.load_module(p)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def top_level(*mods):
    out = subprocess.run([sys.executable, "-c", _PROBE, str(REPO), *mods],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    import json
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    names = top_level("chipbench.harness.bench", "chipbench.calibrate",
                      "chipbench.drivers.train_loop",
                      "chipbench.drivers.session_loop",
                      "repro_torch.launch.train", "repro_torch.sessions",
                      "repro_torch.train.serve_step")
    assert not names & BANNED, names & BANNED
    assert "repro_torch" in names and "chipbench" in names


def test_the_reference_imports_nothing_of_the_program():
    names = top_level("chipbench.reference.model",
                      "chipbench.reference.counts",
                      "chipbench.reference.digest",
                      "chipbench.reference.peaks")
    assert not names & (BANNED | {"repro_torch"})


@pytest.mark.parametrize("path", sorted(
    (REPO / "chipbench").rglob("*.py")), ids=lambda p: p.name)
def test_no_source_names_jax_or_the_jax_package(path):
    text = path.read_text()
    for mod in BANNED:
        assert not re.search(rf"^\s*(import|from)\s+{mod}(\.|\s|$)", text,
                             re.M), mod
    if "reference" in path.parts:
        assert "repro_torch" not in text


def test_forbidden_modules_compare_whole_names(monkeypatch):
    from chipbench.harness import bench
    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    assert bench.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & BANNED)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in bench.forbidden_modules()


def run_cli(cwd, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "chipbench/run.py", "--workload",
         "qwen05b.train.top2", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=timeout)


def test_without_a_card_a_run_fails_and_prints_no_result(no_card):
    out = run_cli(REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_with_the_benchmark_alone_a_run_fails(tmp_path):
    root = copy_benchmark(tmp_path / "alone")
    out = run_cli(root)
    assert out.returncode != 0 and out.stdout.strip() == ""
