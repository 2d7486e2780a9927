"""One run of one cell: set-up, the measured window, the reading of the
trace, and the comparison with the plain reference that decides ``correct``.

Everything that belongs to a configuration, a traffic mix or a per-layer
metric is found by name: ``BENCHMARK.json`` names the cell, its
configuration file and its traffic (``benchmark/traffic/<traffic>.json``);
the configuration names its generator (``benchmark/generators/<name>.py``),
the traffic its driver (``benchmark/drivers/<name>.py``), and each
per-layer metric has a reader ``benchmark/metrics/<metric>.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import random
import sys
import time
from pathlib import Path

from . import trace, window

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names that must not be loaded in the process that prints
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "lp_mp_tpu")


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is one of ``FORBIDDEN_MODULES``."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN_MODULES})


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module of this package."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    if "." not in name:
        return importlib.import_module(f"{__package__}.{kind}.{name}")
    spec = importlib.util.spec_from_file_location(f"{__package__}.{kind}._{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(spec: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's entry with its configuration and traffic files read, and
    the metrics it reports."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)

    def reported(metrics):
        return [m for m in metrics if "workloads" not in m or workload in m["workloads"]]
    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": reported(spec["end_to_end"]), "per_layer": reported(spec["per_layer"])}


@dataclasses.dataclass
class Ctx:
    """What a driver gets: the cell's files, the seed, the device, the spans,
    and the set-up clock."""
    config: dict
    traffic: dict
    seed: int
    device: object
    spans: trace.Spans
    generator: object
    setup: dict = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def split(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.setup[name] = self.setup.get(name, 0.0) + time.perf_counter() - t

    def sync(self):
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)


def draw_sample(n: int, seed: int, k: int, longest: int) -> list:
    """``k`` of the ``n`` counted solves, drawn from the seed, with the
    longest among them."""
    rng = random.Random(seed * 7919 + 17)
    pick = set(rng.sample(range(n), min(k, n)))
    if longest not in pick and pick:
        pick.discard(max(pick))
        pick.add(longest)
    return sorted(pick)


def measure(cs: dict, seed: int, seconds: float, traced: bool, device, log=print,
            t_start: "float | None" = None, keep_answers: bool = False) -> dict:
    """Set up the cell, run its window, judge a sample of its solves.
    Returns the run's record (metrics not yet selected for printing); with
    ``keep_answers`` also the runner, which holds the answers and the
    instances, and the sample."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    spans = trace.Spans(traced, device)
    generator = load_module("generators", cs["config"]["generator"])
    driver = load_module("drivers", cs["traffic"]["driver"])
    ctx = Ctx(cs["config"], cs["traffic"], seed, device, spans, generator)
    runner = driver.Runner(ctx)
    ctx.sync()

    prof = trace.profiler(device) if traced else None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    if prof is not None:
        prof.start()
    solves = []
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < seconds:
        try:
            with spans("solve"):
                s = runner.solve(k)
        except Exception as e:       # a failed solve is counted, and the run goes on
            log(f"solve {k} failed: {type(e).__name__}: {e}")
            now = time.perf_counter()
            s = window.Solve(now, now, 0, math.nan, math.nan, ok=False)
        solves.append(s)
        k += 1
    ctx.sync()
    if prof is not None:
        prof.stop()
    done = window.counted(solves, t0, seconds)
    rec = {"setup_s": setup_s, "setup_split": dict(ctx.setup), "attempted": len(solves),
           "failed": sum(not s.ok for s in solves), "n_counted": len(done),
           "e2e": window.end_to_end([s for s in done if s.ok], t0, seconds),
           "solves": done, "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                                 if device.type == "cuda" else 0)}
    if prof is not None:
        t = time.perf_counter()
        rec["trace"] = trace.read(prof, len(done))
        rec["trace_read_s"] = time.perf_counter() - t
        del prof
    # the reference runs last, after the program's state is freed
    t = time.perf_counter()
    ok = [i for i, s in enumerate(done) if s.ok]
    checks = {}
    if ok:
        longest = max(ok, key=lambda i: done[i].iterations)
        sample = draw_sample(len(ok), seed, cs["traffic"]["check_solves"], ok.index(longest))
        sample = [ok[i] for i in sample]
        runner.free()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        checks = runner.judge(sample)
        if keep_answers:
            rec["runner"], rec["sample"] = runner, sample
    rec["checks"] = checks
    rec["reference_s"] = time.perf_counter() - t
    return rec


def verdict(rec: dict, limits: dict) -> tuple:
    """(correct, {check: {"value", "limit"}}).  A missing reading, a failed
    solve or an empty window is not correct."""
    shown = {name: {"value": rec["checks"].get(name, math.nan), "limit": lim}
             for name, lim in limits.items()}
    good = (rec["n_counted"] > 0 and rec["failed"] == 0 and bool(rec["checks"])
            and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                    for c in shown.values()))
    return good, shown


def quantity(name: str, known) -> "str | None":
    """The longest of ``known`` that ``name`` is, or begins with followed
    by a dot: ``solve_s.kernel`` reports ``solve_s``, ``solve_s.p95`` itself."""
    hits = [q for q in known if name == q or name.startswith(q + ".")]
    return max(hits, key=len) if hits else None


def reader(name: str):
    """The reader of a per-layer metric: ``benchmark/metrics/<name>.py``, or
    that of the longest prefix of ``name`` ending before a dot that has one
    (``iters_per_solve.kernel`` is read by ``iters_per_solve.py``)."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        if (BENCH_DIR / "metrics" / f"{'.'.join(parts[:n])}.py").is_file():
            return load_module("metrics", ".".join(parts[:n]))
    raise FileNotFoundError(f"no reader for the metric {name!r} in {BENCH_DIR / 'metrics'}")


def select_metrics(cs: dict, rec: dict, traced: bool) -> tuple:
    """({name: {"value", "unit"}}, [missing names]) of the cell's end-to-end
    metrics (untraced) or per-layer metrics (traced).  An end-to-end metric
    that the window cannot give is missing; a per-layer reader that finds
    nothing leaves its metric out."""
    out, missing = {}, []
    if not traced:
        values = dict(rec["e2e"], setup_s=rec["setup_s"])
        for m in cs["end_to_end"]:
            q = quantity(m["name"], (*window.QUANTITIES, "setup_s"))
            if q in values:
                out[m["name"]] = {"value": values[q], "unit": m["unit"]}
            else:
                missing.append(m["name"])
        return out, missing
    for m in cs["per_layer"]:
        v = reader(m["name"]).read(rec, cs)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out, missing
