"""The Jamba serving cell (`jamba2mini.serve.state`, driver
`hybrid_session_loop`) and the full fine-tune (`qwen05b.train.full`) run
whole on the CPU at a tiny width; the program's counters by leaf group
and of clean bytes written, and their three readers, on a tiny hybrid
session; the decode step's work against a hand count."""
import json
import time

import pytest
import torch

from chipbench.harness import bench
from chipbench.reference import jamba

from .tiny import SERVE, TINY_LIMITS, TRAIN, make_tiny_root, run_tiny, \
    tiny_cell

HYBRID, FULL = "jamba2mini.serve.state", "qwen05b.train.full"
#: one whole 8-layer period at a tiny width; 8 routed experts, 4 held
TINY_JAMBA = {"hidden_size": 64, "num_hidden_layers": 8,
              "num_attention_heads": 4, "num_key_value_heads": 2,
              "intermediate_size": 32, "vocab_size": 512,
              "mamba_dt_rank": 8, "mamba_d_state": 4, "num_experts": 8}
NEW = ("recurrent_dirty_pct.serve", "kv_dirty_pct.serve",
       "clean_written_pct.serve")
#: limits of the logits' gaps at the tiny width, where bfloat16's rounding
#: weighs more than at the published widths the cell's own limits were
#: read at: a 64-wide period reads medians up to 0.086 (CPU), the float8
#: control 0.32
TINY_HYBRID_LIMITS = {"logit_err": 0.15, "slot_err": 0.15}


@pytest.fixture
def hybrid_root(tmp_path):
    """`tiny.make_tiny_root`, with the Jamba configuration cut to a tiny
    width (4 experts held) and its limits and the full fine-tune's those
    of a tiny width."""
    root = make_tiny_root(tmp_path)
    path = root / "chipbench" / "configs" / "ai21-jamba2-mini.ep2.json"
    cfg = json.loads(path.read_text())
    cfg.update(TINY_JAMBA)
    cfg["expert_parallel"]["experts_held"] = 4
    path.write_text(json.dumps(cfg))
    for cell, tiny in ((FULL, TINY_LIMITS[TRAIN]),
                       (HYBRID, TINY_HYBRID_LIMITS)):
        path = root / "chipbench" / "limits" / f"{cell}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()),
                                    **tiny}))
    return root


def tiny_full_cell(root):
    """The full fine-tune with `tiny.tiny_cell`'s training cuts."""
    cell = bench.load_cell(FULL, root)
    cell.traffic.update(batch=8, seq_len=16, save_every=2)
    cell.traffic["check"].update(commit_window=1, chunks_per_commit=64)
    cell.traffic["chipmink"].update(chunk_bytes=4096)
    return cell


def test_a_tiny_hybrid_serving_run_is_correct_and_reports_its_metrics(
        hybrid_root):
    cell = tiny_cell(hybrid_root, HYBRID)
    out = run_tiny(cell, seconds=2.0)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(cell.limits)
    assert set(out["metrics"]) == {"serve_tokens_per_s", "token_gap_p95_ms",
                                   "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("name", [HYBRID, SERVE])
def test_a_traced_tiny_serving_run_reads_the_new_counters(
        hybrid_root, monkeypatch, name):
    monkeypatch.setattr(bench.Run, "tracer", lambda self: None)
    cell = tiny_cell(hybrid_root, name)
    out = bench.run_cell(cell, 2**31 + 27, 2.0, True, "cpu",
                         time.perf_counter())
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items() if k in NEW}
    if name == HYBRID:
        assert set(got) == set(NEW) and got["recurrent_dirty_pct.serve"] \
            == 100.0
    else:
        assert set(got) == set(NEW) - {"recurrent_dirty_pct.serve"}
    assert 0 <= got["kv_dirty_pct.serve"] <= 100
    assert 0 <= got["clean_written_pct.serve"] <= 100


def test_a_tiny_full_fine_tune_is_correct(hybrid_root):
    cell = tiny_full_cell(hybrid_root)
    assert cell.traffic["trained"]["top_layers"] == "all"
    out = run_tiny(cell, seconds=2.0)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train_tokens_per_s", "setup_s"}


def test_the_counters_and_readers_on_a_tiny_hybrid_session():
    """Chunks of one token's K or V row of one attention layer and
    request: after `steps` decode steps the KV share read is the rows
    those steps wrote, and the recurrent share is every chunk."""
    from repro_torch.configs import get_config
    from repro_torch.core import LGA, MemoryStore
    from repro_torch.models.model import api, init_model_params
    from repro_torch.sessions import SessionService
    cfg = get_config("ai21-jamba2-mini").reduced()
    B, T, steps = 2, 16, 3
    row = cfg.n_kv_heads * cfg.hd * 2                    # bf16 bytes
    svc = SessionService(MemoryStore(), pool_size=1, policy=LGA(),
                         chunk_bytes=row, device="cpu")
    svc.open_session("s")
    m = api(cfg)
    params = init_model_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    cache = m.init_cache(cfg, B, T, device="cpu")
    draw = torch.Generator().manual_seed(1)
    stats = []
    for n in (5, steps):
        for _ in range(n):
            tok = torch.randint(0, cfg.vocab, (B, 1), generator=draw,
                                dtype=torch.int32)
            _, cache = m.decode_step(params, cache, tok, cfg)
        svc.save_session("s", {"cache": cache})
        stats.append(svc.pool[0].save_stats[-1])
    st = stats[-1]
    n_attn = sum(mx == "attn" for mx, _ in cfg.layer_plan())
    n_rec = cfg.n_layers - n_attn
    Ei, N, K = cfg.ssm.expand * cfg.d_model, cfg.ssm.d_state, cfg.ssm.d_conv
    assert st["chunks_by_group"] == {
        "k": n_attn * B * T, "v": n_attn * B * T, "pos": 1,
        "conv": n_rec * B * (K - 1) * Ei * 2 // row,
        "ssm": n_rec * B * Ei * N * 4 // row}
    assert sum(st["chunks_by_group"].values()) == st["n_chunks"]
    assert sum(st["dirty_by_group"].values()) == st["n_dirty_chunks"]
    assert st["dirty_by_group"]["k"] == st["dirty_by_group"]["v"] \
        == n_attn * B * steps
    rec = {"save_stats": [st]}
    read = {name: bench.load_module(
        bench.ROOT / "chipbench" / "metrics" / f"{name}.py").read
        for name in NEW}
    assert read["recurrent_dirty_pct.serve"](rec) == 100.0
    assert read["kv_dirty_pct.serve"](rec) == 100.0 * steps / T
    dirty_bytes = sum(v for k, v in st["dirty_by_group"].items()
                      if k != "pos") * row
    assert st["written_chunk_bytes"] >= dirty_bytes
    assert 0 <= st["clean_written_bytes"] \
        <= st["written_chunk_bytes"] - dirty_bytes
    assert read["clean_written_pct.serve"](rec) == pytest.approx(
        100.0 * st["clean_written_bytes"] / st["written_chunk_bytes"])
    manifest = svc.store.get_manifest(st["time_id"])
    assert "chunks_by_group" not in manifest["stats"]
    assert "clean_written_bytes" not in manifest["stats"]


def test_the_readers_read_nothing_without_the_counters():
    rec = {"save_stats": [{"n_chunks": 10, "n_dirty_chunks": 1,
                           "pods_written": 1, "pods_aliased": 3}]}
    for name in NEW:
        read = bench.load_module(bench.ROOT / "chipbench" / "metrics"
                                 / f"{name}.py").read
        assert read(rec) is None and read({}) is None


def test_decode_step_flops_against_a_hand_count():
    s = jamba.Shape.of(json.loads(
        (bench.ROOT / "chipbench" / "configs"
         / "ai21-jamba2-mini.ep2.json").read_text()))
    attn = 2 * 4096 * (32 + 2 * 8) * 128 + 2 * 4096 * 4096
    mamba = 2 * 4096 * 16384 + 2 * 8192 * (256 + 32) + 2 * 256 * 8192 \
        + 2 * 8192 * 4096
    ffn = 3 * 2 * 4096 * 14336
    # the router, and this chip's share of the top-2: 8 held of 16
    moe = 2 * 4096 * 16 + 2 * 8 / 16 * ffn
    head = 2 * 4096 * 65536
    per_token = 4 * attn + 28 * mamba + 16 * moe + 16 * ffn + head
    scores = 4 * 2 * 2 * 32 * 128 * (11 + 12 + 13 + 14)
    assert jamba.decode_step_flops(s, 4, [10, 11, 12, 13]) == \
        4 * per_token + scores
    assert per_token == 18_035_507_200
