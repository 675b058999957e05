"""`calibrate.py`'s readings for a cell whose traffic runs the driver
`hybrid_session_loop`: the program over each seed, the float8 control,
a served token altered and a wrong slot, scored by the Jamba reference
(`reference/jamba.py`) in place of `reference/model.py`.  The
benchmark's own runs never run this.

    python3 chipbench/calibrate_hybrid.py --workload <name> \
        --seeds <n> ... [--seconds <s>]

`calibrate.serve_readings` imports its reference as
``chipbench.reference.model``; the package's attribute of that name is
pointed at the Jamba reference for this process.  Retires with
`drivers/hybrid_session_loop.py`, once a configuration file names its
reference.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chipbench.reference
    from chipbench import calibrate
    from chipbench.reference import jamba
    chipbench.reference.model = jamba
    return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
