"""Helpers of the benchmark's CPU tests: a temporary copy of the
benchmark whose configurations keep their structure at a tiny width, so
a whole run of a cell (set-up, window, checks) takes seconds on the CPU,
with the program's plain (CPU) kernels."""
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TRAIN, SERVE = "qwen05b.train.top2", "granite3b.serve.prefix"
#: every width cut, every other key as in the cell's own files
TINY = {"hidden_size": 64, "num_hidden_layers": 3, "num_attention_heads": 4,
        "num_key_value_heads": 2, "intermediate_size": 128,
        "vocab_size": 512}
TINY_MOE = {"num_local_experts": 8, "num_experts_per_tok": 2,
            "intermediate_size": 32}
#: limits of the model's gaps at the tiny width, where bfloat16's
#: rounding weighs more than at the published widths the cell's own
#: limits were read at (a 64-wide step reads window gaps of up to 8.7e-4
#: in its loss and 7.9e-3 in its change, CPU)
TINY_LIMITS = {TRAIN: {"loss_gap": 3e-3, "window_loss_gap": 3e-3,
                       "window_change_gap": 0.05}}


def copy_benchmark(dest: Path) -> Path:
    """BENCHMARK.json and chipbench/ (tests and caches left out) under
    `dest`."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copy(REPO / "BENCHMARK.json", dest)
    shutil.copytree(REPO / "chipbench", dest / "chipbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    return dest


def make_tiny_root(tmp_path: Path) -> Path:
    root = copy_benchmark(tmp_path / "checkout")
    for name, extra in (("qwen1.5-0.5b", {}),
                        ("granite-moe-3b-a800m", TINY_MOE)):
        path = root / "chipbench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(TINY, **extra)
        cfg["reduced"] = sorted(set(TINY) | set(extra))
        path.write_text(json.dumps(cfg))
    for cell, tiny in TINY_LIMITS.items():
        path = root / "chipbench" / "limits" / f"{cell}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **tiny}))
    return root


def tiny_cell(root: Path, name: str):
    """The cell from `root`, its traffic cut to what the CPU runs in
    seconds: shorter sequences, turns and cycles."""
    from chipbench.harness import bench
    cell = bench.load_cell(name, root)
    if name == TRAIN:
        cell.traffic.update(batch=8, seq_len=16, save_every=2)
        cell.traffic["check"].update(commit_window=1, chunks_per_commit=64)
        cell.traffic["chipmink"].update(chunk_bytes=4096)
    else:
        cell.traffic.update(prompt_tokens=4, shared_prefix_tokens=3,
                            gen_tokens=6, cache_slots=16,
                            first_offset_steps=3, stagger_steps=3,
                            save_every=3)
        cell.traffic["check"].update(commit_window=1)
    return cell


def run_tiny(cell, seed: int = 2**31 + 11, seconds: float = 1.0):
    import time

    from chipbench.harness import bench
    return bench.run_cell(cell, seed, seconds, False, "cpu",
                          time.perf_counter())
