"""Incremental serving-state persistence, fleet edition, on the PyTorch
port: a multi-session `SessionService` decode with per-session branch
snapshots, cross-session pod dedup on the shared prompt prefix, and
O(delta) session eviction.

    PYTHONPATH=src python examples_torch/incremental_serving.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.serve import serve


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    out = serve("starcoder2-3b", n_requests=4, gen_tokens=24, cache_len=64,
                save_every=8, reduced=True, n_sessions=3, device=a.device)
    stats = out["snap_stats"]
    first, last = stats[0], stats[-1]
    print(f"\nfirst snapshot wrote {first['bytes_written']/1e3:.1f} KB; "
          f"steady-state snapshot wrote {last['bytes_written']/1e3:.1f} KB "
          f"({last['bytes_written']/max(first['bytes_written'],1)*100:.0f}%)"
          f" — ring-buffer deltas only")
    fleet = out["fleet"]
    print(f"fleet: {fleet['n_sessions']} live sessions, "
          f"{fleet['dedup_ratio']:.2f}x cross-session dedup on the shared "
          f"prefix, {fleet['bytes_per_session']/1e3:.1f} KB/session; "
          f"evicting one idle session reclaimed "
          f"{out['evict_stats'].bytes_reclaimed/1e3:.1f} KB without a "
          f"full GC")


if __name__ == "__main__":
    main()
