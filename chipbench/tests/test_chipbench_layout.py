"""BENCHMARK.json keeps to the benchmark's contract, every name finds its
file, and a later configuration, traffic mix or per-layer metric is added
as new files alone."""
import json
import re

import pytest

from chipbench.harness import bench

from .tiny import REPO, SERVE, TRAIN, copy_benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def test_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["chipbench"]
    assert BENCH["command"] == ["python3", "chipbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"]
             + metrics]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "layer", "moves", "workloads"}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len((REPO / "BENCHMARK.json").read_bytes()) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_set_up_another_metric_and_its_layers(cell):
    c = bench.load_cell(cell, REPO)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer and all(m["moves"] in e2e for m in c.per_layer)
    assert c.chips == 1
    for m in c.per_layer:
        assert (REPO / "chipbench" / "metrics" / f"{m['name']}.py").exists()
        assert bench.reader(c, m["name"])({}) is None
    assert (REPO / "chipbench" / "drivers"
            / f"{c.traffic['driver']}.py").exists()


def test_layers_are_named_alike_and_shares_are_rooflines_or_mfu():
    for m in BENCH["per_layer"]:
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"
    assert {m["layer"] for m in BENCH["per_layer"]} == {
        "training loop", "checkpoint call", "graph", "change detection",
        "podding", "gather", "write", "sessions", "serving loop", "kernels",
        "device"}


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_name_their_source_and_their_departures(conf):
    cfg = json.loads((REPO / conf["file"]).read_text())
    assert conf["source"] == cfg["source"]
    assert re.match(r"^https://huggingface\.co/[\w.-]+/[\w.-]+$",
                    cfg["source"])
    assert conf["reduced"] == cfg["reduced"] == []
    assert cfg["assumed"] and cfg["departures"]
    if conf["name"] == "granite-moe-3b-a800m":
        text = " ".join(cfg["departures"])
        assert "granite-3.0-1b-a400m" in text
        for k in ("embedding_multiplier", "attention_multiplier",
                  "residual_multiplier", "logits_scaling"):
            assert k in text


def test_a_new_cell_metric_and_traffic_are_found_by_name(tmp_path):
    root = copy_benchmark(tmp_path / "checkout")
    b = json.loads((root / "BENCHMARK.json").read_text())
    traffic = json.loads((root / "chipbench" / "traffic" / "serve.prefix.json")
                         .read_text())
    (root / "chipbench" / "traffic" / "serve.noprefix.json").write_text(
        json.dumps(dict(traffic, shared_prefix_tokens=0)))
    (root / "chipbench" / "limits" / "granite3b.serve.noprefix.json") \
        .write_text((root / "chipbench" / "limits" / f"{SERVE}.json")
                    .read_text())
    (root / "chipbench" / "metrics" / "zz_probe.serve.py").write_text(
        "def read(rec):\n    return rec.get('probe')\n")
    b["workloads"].append({"name": "granite3b.serve.noprefix",
                           "config": "granite-moe-3b-a800m",
                           "traffic": "serve.noprefix", "chips": 1,
                           "why": "the same traffic with no shared prompt"})
    for m in b["end_to_end"]:
        if "workloads" in m and SERVE in m["workloads"]:
            m["workloads"].append("granite3b.serve.noprefix")
    b["per_layer"].append({"name": "zz_probe.serve", "unit": "%",
                           "better": "higher", "source": "program_counter",
                           "layer": "write", "moves": "token_gap_p95_ms"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = bench.load_cell("granite3b.serve.noprefix", root)
    assert cell.traffic["shared_prefix_tokens"] == 0
    assert "zz_probe.serve" in [m["name"] for m in cell.per_layer]
    assert bench.reader(cell, "zz_probe.serve")({"probe": 3.5}) == 3.5
    # a metric without a workloads key reaches every cell that reports
    # what it moves, the old cell too; not the training cell
    assert "zz_probe.serve" in [m["name"] for m in
                                bench.load_cell(SERVE, root).per_layer]
    assert "zz_probe.serve" not in [m["name"] for m in
                                    bench.load_cell(TRAIN, root).per_layer]


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        bench.load_cell("no.such.cell", REPO)
