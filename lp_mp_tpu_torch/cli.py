"""Command-line entry points (counterpart of ``lp_mp_tpu/cli.py``).

Counterpart of the reference's TCLAP-based compositional CLI and the
``LP_MP_CONSTRUCT_SOLVER_*`` main() macros (solver.hxx:490-546): one
subcommand per model family, sharing the algorithm knobs of
StandardVisitor / StandardTighteningVisitor / LP (standard_visitor.hxx:
32-44,263-276; LP_MP.h:588-594).

    python -m lp_mp_tpu_torch mrf input.uai --maxIter 100 --tighten ...
    python -m lp_mp_tpu_torch gm input.tkr --construction both ...
    python -m lp_mp_tpu_torch multicut input.txt ... --device cpu

The knobs are the JAX package's, plus ``--device`` (default ``cuda``),
handed to ``Solver(device=...)``: the port runs on the card unless asked
for the CPU, and without a card and without ``--device cpu`` the command
fails with ``config.entry_device``'s ``RuntimeError``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def _add_common(p: argparse.ArgumentParser) -> None:
    # knob names mirror the reference CLI (standard_visitor.hxx:32-44)
    p.add_argument("inputFile")
    p.add_argument("--maxIter", type=int, default=1000)
    p.add_argument("--timeout", type=float, default=float("inf"))
    p.add_argument("--maxMemory", type=float, default=float("inf"), help="MB")
    p.add_argument("--minDualImprovement", type=float, default=0.0)
    p.add_argument("--minDualImprovementInterval", type=int, default=10)
    p.add_argument("--primalComputationInterval", type=int, default=5)
    p.add_argument("--primalComputationStart", type=int, default=1)
    p.add_argument("--lowerBoundComputationInterval", type=int, default=1)
    p.add_argument("--standardReparametrization", default="anisotropic",
                   choices=["anisotropic", "anisotropic2", "uniform",
                            "damped_uniform", "mixed"])
    p.add_argument("--roundingReparametrization", default="damped_uniform",
                   choices=["anisotropic", "anisotropic2", "uniform",
                            "damped_uniform", "mixed"])
    p.add_argument("--tighten", action="store_true")
    p.add_argument("--tightenIteration", type=int, default=2 ** 62)
    p.add_argument("--tightenInterval", type=int, default=2 ** 62)
    p.add_argument("--tightenConstraintsMax", type=int, default=20)
    p.add_argument("--outputFile", default=None)
    p.add_argument("--databaseFile", default=None, help="sqlite metrics DB")
    p.add_argument("--datasetName", default="default")
    p.add_argument("-v", "--verbosity", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device of the solver, e.g. cuda, cuda:1 or cpu")


def _visitor(args, instance_name: str):
    from .visitors_db import SqliteVisitor
    from .visitors import StandardTighteningVisitor
    kw = dict(
        max_iter=args.maxIter, timeout=args.timeout,
        max_memory_mb=args.maxMemory,
        min_dual_improvement=args.minDualImprovement,
        min_dual_improvement_interval=args.minDualImprovementInterval,
        primal_computation_interval=args.primalComputationInterval,
        primal_computation_start=args.primalComputationStart,
        lower_bound_computation_interval=args.lowerBoundComputationInterval,
        standard_reparametrization=args.standardReparametrization,
        rounding_reparametrization=args.roundingReparametrization,
        tighten=args.tighten, tighten_iteration=args.tightenIteration,
        tighten_interval=args.tightenInterval,
        tighten_constraints_max=args.tightenConstraintsMax)
    if args.databaseFile:
        return SqliteVisitor(db_path=args.databaseFile,
                             dataset_name=args.datasetName,
                             instance_name=instance_name, **kw)
    return StandardTighteningVisitor(**kw)


def _finish(args, solver, lines: list[str]) -> None:
    print(f"lower bound: {solver.lower_bound()}")
    print(f"upper bound: {solver.primal_cost()}")
    if args.outputFile:
        with open(args.outputFile, "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
        print(f"primal written to {args.outputFile}")
    if hasattr(solver.visitor, "close"):
        solver.visitor.close()


def cmd_mrf(args) -> int:
    from . import config
    from .io.uai import parse_and_build
    from .models.mrf import MrfConstructor, mrf_labeling
    from .solver import Solver
    config.verbosity = args.verbosity
    s = Solver(visitor=_visitor(args, args.inputFile), device=args.device)
    mrf = s.add_constructor(
        MrfConstructor, pairwise_rep="dense" if args.tighten else "auto")
    with open(args.inputFile) as f:
        parse_and_build(f.read(), mrf)
    s.solve()
    lines = []
    if s.best_primal is not None:
        lab = mrf_labeling(mrf, s.engine, s.best_primal)
        lines = [str(int(x)) for x in lab]
    _finish(args, s, lines)
    return 0


def cmd_gm(args) -> int:
    from . import config
    from .io.torresani import parse_file
    from .models.graph_matching import GraphMatchingConstructor
    from .solver import Solver
    config.verbosity = args.verbosity
    s = Solver(visitor=_visitor(args, args.inputFile), device=args.device)
    gm = s.add_constructor(GraphMatchingConstructor,
                           construction=args.construction)
    gm.construct(parse_file(args.inputFile))
    s.solve()
    prim = gm.compute_primal(s.engine)
    s.register_primal(prim)
    match = gm.matching(s.engine, prim)
    _finish(args, s, [f"{i} -> {int(j)}" for i, j in enumerate(match)])
    return 0


def cmd_multicut(args) -> int:
    from . import config
    from .models.multicut import MulticutConstructor
    from .solver import Solver
    config.verbosity = args.verbosity
    s = Solver(visitor=_visitor(args, args.inputFile), device=args.device)
    mc = s.add_constructor(MulticutConstructor)
    with open(args.inputFile) as f:
        for raw in f:
            line = raw.split("#")[0].strip()
            if not line or line.upper().startswith("MULTICUT"):
                continue
            i, j, w = line.split()
            mc.add_edge(int(i), int(j), float(w))
    s.solve()
    labels, cut, cost = mc.round_gaec()
    _finish(args, s, [str(int(x)) for x in labels])
    return 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="lp_mp_tpu_torch",
        description="dual block coordinate ascent solvers in PyTorch")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("mrf", help="MAP-MRF from a .uai file")
    _add_common(p)
    p.set_defaults(fn=cmd_mrf)

    p = sub.add_parser("gm", help="graph matching (Torresani et al format)")
    _add_common(p)
    p.add_argument("--construction", default="left", choices=["left", "both"])
    p.set_defaults(fn=cmd_gm)

    p = sub.add_parser("multicut", help="multicut from 'i j w' edge lines")
    _add_common(p)
    p.set_defaults(fn=cmd_multicut)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
