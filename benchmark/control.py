"""Readings from which the limits of ``correct`` are set, at a cell's own size.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 --seconds 5 [--control bfloat16]

For each seed: the cell's set-up, a window of ``--seconds``, and the
comparison of a sample of its solves with the plain reference (the
program's readings, with the instance and the number of calls of each
compared solve); with ``--control``, the same comparison with the
reference computed in that precision answering in the program's place, on
the same solves' calls (the control's readings).  One JSON line per seed.
The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", default=None, help="a torch dtype name, e.g. bfloat16")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from benchmark import run
    for key, rel in run.CACHES.items():
        os.environ[key] = str(ROOT / rel)
        os.makedirs(os.environ[key], exist_ok=True)
    import torch

    from benchmark import harness
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cs = harness.cell_spec(harness.load_spec(), args.workload)
    control = getattr(torch, args.control) if args.control else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        rec = harness.measure(cs, seed, args.seconds, False, device, log=print,
                              keep_answers=True)
        runner = rec.pop("runner")
        answers = [runner.answers[k] for k in rec["sample"]]
        line = {"workload": args.workload, "seed": seed, "solves": rec["n_counted"],
                "compared": [[a.get("instance", 0), len(a["ops"])] for a in answers],
                "program": rec["checks"]}
        if control is not None:
            line["control"] = runner.judge(rec["sample"], control)
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        del runner
    return 0


if __name__ == "__main__":
    sys.exit(main())
