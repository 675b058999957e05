"""Readings that set the limits of `correct`: the program's, the
control's and the planted faults', on the card at a cell's own size.
The benchmark's own runs never run this.

    python3 chipbench/calibrate.py --workload <name> --seeds <n> ... \
        [--seconds <s>]

For each seed the cell runs once with a window of ``--seconds``, and the
numbers its check compares are read (``program``).  Then, from what the
run recorded, each reading below is put in the program's place and
compared as the benchmark compares the program.

A training cell (driver ``train_loop``): the reference's steps, the
first ones from the weights made from the seed and the window step from
the commit's state, computed again as the control (float8 e4m3 operands
in every matrix product) and with the fault "half of the batch left
out, the mean taken over the rest" (``half_batch``).  A state left
unchanged reads 1 on ``change_gap`` and ``window_change_gap`` by that
measure and needs no run.

A serving cell (driver ``session_loop``): the sampled requests, scored
with the reference's own float8 logits and the token they put first at
each position of the same prompts and tokens (``control``); with one
served token of each request altered (``token_altered``); and with one
slot's logits those of another slot's requests of the sample at the
same positions (``wrong_slot``).

Prints one JSON line per seed and reading.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def cell_record(cell, seed: int, seconds: float, device: str):
    """Run the cell once; its record, with the checks it made."""
    import torch
    from chipbench.harness import bench
    run = bench.Run(cell=cell, seed=seed, seconds=seconds, trace=False,
                    device=torch.device(device),
                    t_start=time.perf_counter())
    bench.driver(cell).run(run)
    return run.record


def emit(rows: list, seed: int, name: str, chk) -> None:
    rows.append({"seed": seed, "reading": name,
                 "correct": all(c["value"] <= c["limit"]
                                for c in chk.items.values()),
                 **{k: c["value"] for k, c in chk.items.items()}})
    print(json.dumps(rows[-1]), flush=True)


def train_readings(cell, seed: int, seconds: float,
                   device: str = "cuda") -> list:
    import torch
    from chipbench.drivers import train_loop
    from chipbench.harness import checks
    from chipbench.harness import traffic as gen
    from chipbench.reference import model as ref
    rec = cell_record(cell, seed, seconds, device)
    rows: list = []
    emit(rows, seed, "program", rec["checks"])
    t = cell.traffic
    s = ref.Shape.of(cell.config)
    trained = gen.trained_prefixes(t["trained"], s.L)
    stream = gen.LMStream(t, s.V, seed)
    batches = [train_loop.on(stream(k), device)
               for k in range(t["reference_steps"])]
    opt = ref.AdamW(**t["optimizer"])
    params = ref.make_params(s, seed, device)
    r = ref.train_steps(params, batches, s, trained, opt)
    w = rec.get("window_step")
    for name, kw in (("control", {"prec": ref.FP8_CONTROL}),
                     ("half_batch", {"rows": t["batch"] // 2})):
        chk = checks.Checks(cell.limits)
        v = ref.train_steps(params, batches, s, trained, opt, **kw)
        train_loop.readings(chk, v["losses"], v["grad"], v["change"], r)
        del v
        if w is not None:
            v = ref.train_steps(w["params"], [w["batch"]], s, trained, opt,
                                moments=w["moments"], count0=w["count0"],
                                **kw)
            train_loop.window_readings(chk, v["losses"][0], v["change"],
                                       w["ref"])
            del v
        emit(rows, seed, name, chk)
        if device == "cuda":
            torch.cuda.empty_cache()
    return rows


def serve_readings(cell, seed: int, seconds: float,
                   device: str = "cuda") -> list:
    import torch
    from chipbench.harness import checks
    from chipbench.harness import traffic as gen
    from chipbench.reference import model as ref
    rec = cell_record(cell, seed, seconds, device)
    rows: list = []
    emit(rows, seed, "program", rec["checks"])
    served = rec.get("served")
    if served is None:
        return rows
    s = ref.Shape.of(cell.config)
    params = ref.make_params(s, seed, device)
    seqs, logits, slots, prompt = (served[k] for k in
                                   ("seqs", "logits", "slots", "prompt"))
    # a token altered where it is produced: one served token of each
    # request, drawn from the seed, one id up
    bad = seqs.clone()
    cols = gen.rng(seed, 5).integers(prompt, seqs.shape[1],
                                     size=seqs.shape[0])
    at = torch.arange(seqs.shape[0], device=seqs.device)
    cols = torch.from_numpy(cols).to(seqs.device)
    bad[at, cols] = (bad[at, cols] + 1) % s.V
    # a wrong slot: slot 0's requests get the logits of another slot's
    # requests at the same positions
    first = [i for i, r in enumerate(slots) if r == 0]
    other = [i for i, r in enumerate(slots) if r != 0][:len(first)]
    wrong = logits.clone()
    wrong[first[:len(other)]] = logits[other]
    for name, scored in (
            ("control", ref.served_scores(params, s, seqs, prompt,
                                          prec=ref.FP8_CONTROL,
                                          slots=slots)),
            ("token_altered", ref.served_scores(params, s, bad, prompt)),
            ("wrong_slot", ref.served_scores(params, s, seqs, prompt,
                                             logits=wrong, slots=slots))):
        chk = checks.Checks(cell.limits)
        for k, v in zip(("token_gap", "logit_err", "slot_err"), scored):
            if v is not None:
                chk.add(k, v)
        emit(rows, seed, name, chk)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    a = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chipbench.harness import bench
    cell = bench.load_cell(a.workload, ROOT)
    readings = train_readings if cell.traffic["driver"] == "train_loop" \
        else serve_readings
    for seed in a.seeds:
        readings(cell, seed, a.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
