"""The control: the reference put in the program's place in the nearest
precision below the configuration's (float8 operands for bfloat16), and
the planted faults that `chipbench/calibrate.py` reads, at a size a test
run holds; each comes out not correct under the cell's own limits."""
import json

import pytest
import torch

from chipbench import calibrate
from chipbench.harness import traffic as gen
from chipbench.reference import model as ref

from .tiny import REPO, SERVE, TRAIN, tiny_cell

#: the serving configuration at a width and depth where float8's error
#: builds up over the layers as it does at full size
MID = {"hidden_size": 128, "num_attention_heads": 4, "num_key_value_heads": 2,
       "intermediate_size": 64, "num_local_experts": 8,
       "num_experts_per_tok": 2, "num_hidden_layers": 8, "vocab_size": 512}


def test_the_training_control_and_half_batch_fail(tiny_root):
    cell = tiny_cell(tiny_root, TRAIN)
    rows = {r["reading"]: r for r in
            calibrate.train_readings(cell, 2**31 + 21, 4.0, "cpu")}
    assert set(rows) == {"program", "control", "half_batch"}
    assert rows["program"]["correct"], rows["program"]
    assert not any(rows[k]["correct"] for k in ("control", "half_batch"))
    # the window step is read too, on every reading
    assert all("window_change_gap" in r for r in rows.values())


@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_the_serving_control_and_an_altered_token_fail(seed):
    limits = json.loads((REPO / "chipbench" / "limits" / f"{SERVE}.json")
                        .read_text())
    traffic = json.loads((REPO / "chipbench" / "traffic" / "serve.prefix.json")
                         .read_text())
    traffic.update(prompt_tokens=8, shared_prefix_tokens=6)
    cfg = json.loads((REPO / "chipbench" / "configs"
                      / "granite-moe-3b-a800m.json").read_text())
    s = ref.Shape.of(dict(cfg, **MID))
    params = ref.make_params(s, seed, "cpu")
    seqs = torch.from_numpy(gen.Conversations(traffic, s.V, seed)(0, 0))
    with torch.no_grad():                # the reference's own greedy tokens
        for _ in range(8):
            nxt = ref.forward(params, seqs, s)[:, -1].argmax(-1)
            seqs = torch.cat([seqs, nxt[:, None].to(seqs.dtype)], 1)
    assert ref.served_scores(params, s, seqs, 8)[0] == 0.0
    control = ref.served_scores(params, s, seqs, 8, prec=ref.FP8_CONTROL)
    assert control[1] > limits["logit_err"], control
    altered = seqs.clone()
    altered[:, 10] = (altered[:, 10] + 1) % s.V
    assert ref.served_scores(params, s, altered, 8)[0] > limits["token_gap"]


def test_calibrate_scores_program_control_and_fault(tiny_root):
    cell = tiny_cell(tiny_root, SERVE)
    rows = {r["reading"]: r for r in
            calibrate.serve_readings(cell, 2**31 + 23, 3.0, "cpu")}
    assert set(rows) == {"program", "control", "token_altered",
                         "wrong_slot"}
    assert rows["token_altered"]["token_gap"] > cell.limits["token_gap"]
    assert rows["control"]["logit_err"] > rows["program"]["logit_err"]
    assert rows["wrong_slot"]["slot_err"] > cell.limits["slot_err"]
