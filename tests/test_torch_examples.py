"""The port's examples (`examples_torch/`) run to their end on the CPU,
each in a subprocess with ``--device cpu`` (one intra-op thread: the
suite runs several workers at once); without it they ask for the card
and fail without one."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
#: example -> a line its run must print
EXAMPLES = {
    "quickstart.py": "round-trip equivalence",
    "branch_and_timetravel.py": "time-travel to tag 'base': step=10",
    "incremental_serving.py": "cross-session dedup",
    "elastic_restart.py": "elastic restore onto mesh {'data': 1, "
                          "'model': 1}",
}


def _run(name: str, *args: str, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               **(env_extra or {}))
    return subprocess.run([sys.executable, str(ROOT / "examples_torch" / name),
                           *args], capture_output=True, text=True, env=env,
                          timeout=60, cwd=str(ROOT))


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name):
    out = _run(name, "--device", "cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    assert EXAMPLES[name] in out.stdout, out.stdout[-3000:]


def test_examples_default_to_the_card():
    # the CPU torch of the tests has no card: the default device raises
    out = _run("quickstart.py", env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "CUDA" in out.stderr


def test_examples_cover_the_reference_examples():
    assert sorted(p.name for p in (ROOT / "examples").glob("*.py")) == \
        sorted(EXAMPLES)
