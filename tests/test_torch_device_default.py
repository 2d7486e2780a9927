"""The port's entry points run on the card unless the caller asks for the CPU.

``GridPottsModel``, ``Engine`` and ``Solver`` default to ``device="cuda"``
and ``ShardedGridPotts`` and ``ShardedEngine`` to every CUDA device.  Where no CUDA device is
present they raise a ``RuntimeError`` that names ``device="cpu"``; none of
them falls back to the CPU.  The no-card cases patch
``torch.cuda.is_available`` to false, so they hold on any machine; the case
that checks where the default lands is marked ``gpu`` and skips without a
card.  This file imports no JAX, so on the card it runs with ``--noconftest``.
"""
import numpy as np
import pytest
import torch

from lp_mp_tpu_torch import cli
from lp_mp_tpu_torch import (Engine, FactorGraph, GridPottsModel, MrfConstructor,
                             ShardedEngine, ShardedGridPotts, Solver, StandardVisitor, random_grid)

GRID = random_grid(5, 6, 3, seed=4)


def chain_graph():
    rng = np.random.default_rng(0)
    g = FactorGraph()
    mrf = MrfConstructor(g)
    mrf.add_unary_factors(rng.normal(size=(4, 3)))
    mrf.add_pairwise_factors(np.array([[0, 1], [1, 2], [2, 3]]), rng.normal(size=(3, 3, 3)))
    return g


def build_grid(**device):
    m = GridPottsModel(*GRID, **device)
    m.run_fast(2)
    return m, m.state["u"].device


def build_engine(**device):
    e = Engine(chain_graph(), **device)
    e.compute_pass("anisotropic")
    return e, e.state["unary_simplex"]["c"].device


def build_solver(**device):
    s = Solver(visitor=StandardVisitor(max_iter=2), **device)
    mrf = s.add_constructor(MrfConstructor)
    rng = np.random.default_rng(1)
    mrf.add_unary_factors(rng.normal(size=(3, 2)))
    mrf.add_pairwise_factors(np.array([[0, 1], [1, 2]]), rng.normal(size=(2, 2, 2)))
    s.solve()
    return s, s.engine.state["unary_simplex"]["c"].device


def build_sharded(**device):
    if "device" in device:
        device = {"devices": [device["device"]] * 2}
    m = ShardedGridPotts(*GRID, **device)
    m.run_fast(2)
    return m, m.windows[0]["u"].device


def build_sharded_engine(**device):
    if "device" in device:
        device = {"devices": [device["device"]] * 3}
    e = ShardedEngine(chain_graph(), **device)
    e.compute_pass("anisotropic")
    return e, e.state["unary_simplex"]["c"].device


ENTRY_POINTS = {"GridPottsModel": build_grid, "Engine": build_engine, "Solver": build_solver,
                "ShardedGridPotts": build_sharded, "ShardedEngine": build_sharded_engine}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_default_raises_without_a_card(entry, no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[entry]()


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_explicit_cuda_raises_without_a_card(entry, no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry](device="cuda:0")


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_explicit_cpu_runs_on_the_cpu(entry):
    obj, dev = ENTRY_POINTS[entry](device="cpu")
    assert dev == torch.device("cpu")
    assert obj is not None


def test_sharded_default_is_every_cuda_device_or_raises(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedGridPotts(*GRID)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedGridPotts(*GRID, devices=["cpu", "cuda:0"])


def test_sharded_engine_default_is_every_cuda_device_or_raises(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedEngine(chain_graph())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedEngine(chain_graph(), devices=["cpu", "cuda:0"])


@pytest.mark.parametrize("k", [1, 2, 4])
def test_sharded_engine_runs_on_cpu_shards(k):
    e = ShardedEngine(chain_graph(), devices=["cpu"] * k)
    e.compute_pass("anisotropic")
    assert e.devices == [torch.device("cpu")] * k
    assert all(v.device.type == "cpu" for loc in e._local for blk in loc.values()
               for v in blk.values())


UAI_PAIR = "MARKOV\n2\n2 2\n3\n1 0\n1 1\n2 0 1\n\n2\n 0.1 0.9\n\n2\n 0.5 0.5\n\n4\n 0 1\n 1 0\n"


@pytest.mark.parametrize("command", ["mrf", "gm", "multicut"])
def test_cli_device_defaults_to_cuda(command):
    assert cli.parser().parse_args([command, "input"]).device == "cuda"
    assert cli.parser().parse_args([command, "input", "--device", "cpu"]).device == "cpu"


def test_cli_without_a_card_raises_unless_asked_for_the_cpu(no_cuda, tmp_path, capsys):
    inp = tmp_path / "pair.uai"
    inp.write_text(UAI_PAIR)
    argv = ["mrf", str(inp), "--maxIter", "3", "-v", "0"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    assert "lower bound:" in capsys.readouterr().out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_default_lands_on_the_card(entry, cuda):
    obj, dev = ENTRY_POINTS[entry]()
    assert dev == cuda
    if entry in ("ShardedGridPotts", "ShardedEngine"):
        assert obj.devices == [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]
    if entry == "GridPottsModel":
        assert obj.state["u"].dtype == torch.float32
