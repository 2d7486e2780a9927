"""lp_mp_tpu_torch: the PyTorch and CUDA port of lp_mp_tpu for NVIDIA Hopper.

It covers the flagship Potts grid: ``GridPottsModel`` with its SRMP
red/black sweeps, lower bound and primal rounding; its row-sharded
counterpart ``ShardedGridPotts`` over a list of devices; and the grid
kernels (``ops/grid_kernels``) written by hand in CUDA for sm_90a.  It also
covers the generic message-passing engine (``Engine`` over a
``FactorGraph``) with the simplex and Potts factors and the
unary-pairwise messages, driven by ``Solver`` and the visitors, with the
MRF constructor and the UAI reader, and with tightening: triplet search and
odd-cycle separation for the MRF, the absorbing aux passes
(``aux_tighten``) and ``Solver.tighten``.  The multicut model family
(``MulticutConstructor``: edge, triplet and odd-wheel factors, cycle and
wheel separation, GAEC rounding) runs on the same engine, and so do graph
matching (``GraphMatchingConstructor`` over ``GraphMatchingInput``: the
``left`` and ``both`` constructions, equality messages, min-cost-flow
rounding with the 2-opt polish) and discrete tomography
(``DiscreteTomographyConstructor``: counting chains whose messages are
min-convolution DPs).  The generic engine also runs sharded over a list of
devices (``ShardedEngine``), and an MRF or any factor graph decomposes into
trees solved exactly (``ChainDecomposition``, ``GeneralTreeDecomposition``
over ``TreeSpec``s, the ``VECTOR_EQUALITY`` coupling, and the ``Solver``'s
switch to trees).  The exact oracles export the local polytope of any of
these models (``build_local_polytope``, ``export_lp_text``,
``solve_lp_relaxation``) and round exactly through HiGHS (``ilp_round``,
``solve_ilp``, ``combi_lp``, ``Solver(exact_rounding=...)``); a solve
stops and resumes through ``save_checkpoint``/``load_checkpoint`` (the JAX
package's file layout) or in memory through ``snapshot``/``restore``; the
sqlite and JSONL visitors record every iteration; ``python -m
lp_mp_tpu_torch {mrf,gm,multicut}`` is the command line.  The package
imports torch and numpy (scipy inside the oracles), never JAX and never
``lp_mp_tpu``.
"""
from .config import (Chirality, Direction, LpControl, MessageSchedule,
                     ReparametrizationMode, eps_for, real_dtype, set_dtype)
from .aux_tighten import AuxPasses
from .checkpoint import load_checkpoint, restore, save_checkpoint, snapshot
from .combilp import combi_lp
from .convert import (aux_state_from_numpy, aux_state_to_numpy, engine_primal_from_numpy,
                      engine_state_from_numpy, engine_state_to_numpy, grid_state_from_numpy,
                      sharded_state_from_jax)
from .engine import Engine
from .graph import FactorGraph
from .io.ilp import IncrementalIlp, ilp_round, solve_ilp
from .io.lp_export import (build_local_polytope, export_lp_file, export_lp_text,
                           solve_lp_relaxation)
from .io.torresani import GraphMatchingInput
from .messages.vector_equality import VECTOR_EQUALITY
from .models.graph_matching import GraphMatchingConstructor
from .models.grid_potts import GridPottsModel, random_grid
from .models.mrf import MrfConstructor
from .models.tomography import DiscreteTomographyConstructor
from .models.multicut import MulticutConstructor
from .parallel.generic import ShardedEngine
from .parallel.grid import ShardedGridPotts
from .solver import Solver
from .trees import ChainDecomposition
from .trees_general import GeneralTreeDecomposition, TreeSpec
from .visitors import StandardTighteningVisitor, StandardVisitor
from .visitors_db import JsonlVisitor, SqliteVisitor

__all__ = [
    "Chirality", "Direction", "LpControl", "MessageSchedule",
    "ReparametrizationMode", "eps_for", "real_dtype", "set_dtype", "AuxPasses",
    "aux_state_from_numpy", "aux_state_to_numpy", "engine_state_from_numpy",
    "engine_state_to_numpy",
    "grid_state_from_numpy", "sharded_state_from_jax", "Engine", "FactorGraph",
    "GraphMatchingInput", "GraphMatchingConstructor", "DiscreteTomographyConstructor",
    "GridPottsModel", "random_grid", "MrfConstructor", "MulticutConstructor", "ShardedGridPotts", "Solver",
    "StandardTighteningVisitor", "StandardVisitor", "ShardedEngine", "ChainDecomposition",
    "GeneralTreeDecomposition", "TreeSpec", "VECTOR_EQUALITY",
    "load_checkpoint", "restore", "save_checkpoint", "snapshot", "combi_lp",
    "engine_primal_from_numpy", "IncrementalIlp", "ilp_round", "solve_ilp",
    "build_local_polytope", "export_lp_file", "export_lp_text", "solve_lp_relaxation",
    "JsonlVisitor", "SqliteVisitor",
]

__version__ = "0.1.0"
