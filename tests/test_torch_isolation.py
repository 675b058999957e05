"""The port stands alone: no JAX, no `ml_dtypes`, no `repro`, no silent
CPU carry-on."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
EXAMPLES = PORT.parents[1] / "examples_torch"
SUBMODULES = sorted(
    "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
    for p in PORT.rglob("*.py") if p.name != "__init__.py")

_PROBE = """
import importlib, sys
import repro_torch
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "ml_dtypes"))
             or m == "repro" or m.startswith("repro."))
print("BAD=" + ",".join(bad))
import torch.distributed as dist
print("PG=" + str(dist.is_available() and dist.is_initialized()))
"""


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(PORT.parent)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", _PROBE, *SUBMODULES],
                         capture_output=True, text=True, env=env,
                         timeout=120, check=True).stdout
    assert "BAD=\n" in out, out
    # importing every module (the dry-run and the mesh included) starts
    # no process group
    assert "PG=False" in out, out
    assert len(SUBMODULES) >= 54
    assert {"repro_torch.launch.dryrun", "repro_torch.launch.mesh",
            "repro_torch.parallel.sharding"} <= set(SUBMODULES)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + sorted(EXAMPLES.glob("*.py")),
                         ids=lambda p: str(p.relative_to(
                             PORT if PORT in p.parents else PORT.parents[1])))
def test_port_sources_do_not_name_jax_or_reference(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import jax|from jax)", text, re.M)
    assert not re.search(r"^\s*(from repro[. ]|import repro\b)", text, re.M)
    assert "from repro." not in text and "import jax" not in text


def test_chipmink_without_cuda_raises(monkeypatch):
    import torch

    from repro_torch.core import Chipmink, MemoryStore
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Chipmink(MemoryStore())
    with pytest.raises(RuntimeError, match="CUDA"):
        Chipmink(MemoryStore(), device="cuda:0")
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import train
    from repro_torch.sessions import SessionService
    with pytest.raises(RuntimeError, match="CUDA"):
        SessionService(MemoryStore())
    with pytest.raises(RuntimeError, match="CUDA"):
        serve("qwen1.5-0.5b", log=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train("qwen1.5-0.5b", steps=1, log=False)
    # the public classes below Chipmink default to the card as well
    from repro_torch.core import Unpodder
    from repro_torch.core.change_detector import ChangeDetector
    from repro_torch.core.memo import GlobalMemoSpace
    with pytest.raises(RuntimeError, match="CUDA"):
        ChangeDetector()
    with pytest.raises(RuntimeError, match="CUDA"):
        Unpodder(GlobalMemoSpace(), lambda pod: b"")
    assert ChangeDetector(device="cpu").device.type == "cpu"
