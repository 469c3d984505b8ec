"""Read the compared numbers of the program and of its control over many
seeds, in one process: the readings each limit in ``traffic/*.json`` is
set from.  The benchmark's own runs never run the control.

    python3 perfbench/seeds.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

One JSON line per seed on standard output: the program's numbers
(``compared``), the control's (``control``), ``correct``, ``attempted``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from perfbench import harness

    for seed in args.seeds:
        out = harness.run_cell(ROOT, args.workload, seed, args.seconds, False,
                               t_start=time.perf_counter(), device=args.device,
                               control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "compared": out["compared"],
                          "control": out["control"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
