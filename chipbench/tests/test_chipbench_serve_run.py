"""A whole run of the serving cell on the CPU at a tiny width."""
from .tiny import SERVE, run_tiny, tiny_cell


def test_a_tiny_serving_run_is_correct_and_reports_its_metrics(tiny_root):
    cell = tiny_cell(tiny_root, SERVE)
    out = run_tiny(cell, seconds=3.0)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(cell.limits)
    assert set(out["metrics"]) == {"serve_tokens_per_s", "token_gap_p95_ms",
                                   "setup_s"}
    assert out["metrics"]["token_gap_p95_ms"]["value"] > 0
    assert out["attempted"] > 0
