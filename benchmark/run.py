"""Run one cell of the benchmark of ``lp_mp_tpu_torch`` once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, the benchmark
and the package, on a machine with an NVIDIA GPU.  Set-up (imports, the
CUDA library, instances, builds, and a warm-up that captures every call the
window makes) counts as ``setup_s``; then solves run back to back for
``--seconds``.
With ``--trace 0`` the last line of standard output is one JSON object with
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics,
read from a ``torch.profiler`` trace of the window.  Once the window has
closed, a sample of the solves drawn from the seed is compared with the
plain reference (``benchmark/reference/``); each compared number and its
limit close the line, under ``checks``, and close standard error.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache inside the checkout, at fixed paths
CACHES = {"LPMP_TORCH_NATIVE_CACHE": "build/benchmark/native",
          "TRITON_CACHE_DIR": "build/benchmark/triton",
          "TORCH_EXTENSIONS_DIR": "build/benchmark/torch_extensions",
          "CUDA_CACHE_PATH": "build/benchmark/nv_compute_cache"}


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc), to 10 ms."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def power_limit_w() -> "float | None":
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
        os.makedirs(os.environ[key], exist_ok=True)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    spec = harness.load_spec()
    cs = harness.cell_spec(spec, args.workload)
    chips = cs["cell"]["chips"]

    t = time.perf_counter()
    import torch
    import lp_mp_tpu_torch  # noqa: F401
    import_s = time.perf_counter() - t
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)

    # set-up runs from the process's start: the interpreter's start before T_START counts
    t_start = T_START - (process_age_s() - (time.perf_counter() - T_START))
    rec = harness.measure(cs, args.seed, args.seconds, bool(args.trace), device, log=log,
                          t_start=t_start)
    rec["setup_split"] = {"import": import_s, **rec["setup_split"]}
    log(f"{args.workload} seed {args.seed}: setup_s {rec['setup_s']:.3f} = "
        + ", ".join(f"{k} {v:.3f}" for k, v in rec["setup_split"].items())
        + f" s (the rest: the interpreter's start and the harness); {rec['n_counted']} solves counted of "
        f"{rec['attempted']} started; reference {rec['reference_s']:.2f} s"
        + (f"; trace read {rec['trace_read_s']:.2f} s" if "trace_read_s" in rec else ""))

    loaded = harness.forbidden_loaded()
    if loaded:
        log(f"modules that the benchmark must not load are loaded: {loaded}: no result")
        return 3
    metrics, missing = harness.select_metrics(cs, rec, bool(args.trace))
    if missing:
        log(f"the window cannot give {missing} ({rec['n_counted']} solves counted); "
            f"it gave {json.dumps(metrics)}: no result")
        return 4
    correct, checks = harness.verdict(rec, cs["traffic"]["limits"])
    device_rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                  "memory_peak_bytes": rec["memory_peak_bytes"],
                  "power_limit_w": power_limit_w()}
    out = {"correct": correct, "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": device_rec}
    if args.trace:
        tr = rec.get("trace") or {}
        device_rec["busy_s"] = tr.get("busy_s", 0.0)
        device_rec["window_s"] = tr.get("window_s", 0.0)
        if tr:
            out["breakdown"] = harness.trace.breakdown(tr)
    out["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
