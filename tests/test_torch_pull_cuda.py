"""The pull pass (``Engine(pull=True)``) on the card (float32).

Marked ``gpu``: where no CUDA device is present every test skips with a
reason.  On a machine with an NVIDIA GPU run ``python -m pytest --noconftest
tests/test_torch_pull_cuda.py`` (the conftest imports JAX, which this file
does not need).  On a 64x64 Potts grid whose pairs are added horizontal
then vertical, every slot of the pull pass is strided: the pass uses no
atomics, so two fresh engines repeat bit for bit; against the scatter pass
(``index_add`` with float atomics) and between captured and eager passes
the bound is held within 1e-5 relative and the state within
1e-5 (1 + max|x|).
"""
import numpy as np
import pytest
import torch

from lp_mp_tpu_torch import Direction, Engine, FactorGraph, MrfConstructor
from lp_mp_tpu_torch.capture import flatten
from lp_mp_tpu_torch.engine_pull import pull_stats

pytestmark = pytest.mark.gpu

REL = 1e-5
PASSES = 10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def strided_grid(H=64, W=64, L=4, seed=1):
    rng = np.random.default_rng(seed)
    g = FactorGraph()
    mrf = MrfConstructor(g)
    mrf.add_unary_factors(rng.normal(size=(H * W, L)))
    idx = np.arange(H * W).reshape(H, W)
    pairs = np.concatenate([
        np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1),
        np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)])
    mrf.add_potts_factors(pairs, L, rng.uniform(0.5, 1.5, size=len(pairs)))
    return g


def engine(g, **kw):
    e = Engine(g, schedule_mode="coloring", device="cuda", dtype=torch.float32, **kw)
    for _ in range(PASSES):
        e.compute_pass("anisotropic")
    return e


def close(a: Engine, b: Engine):
    la, lb = a.lower_bound(), b.lower_bound()
    assert abs(la - lb) <= REL * abs(lb), (la, lb)
    for t in b.state:
        for k, v in b.state[t].items():
            if v.is_floating_point():
                scale = 1.0 + float(v.abs().max())
                assert float((a.state[t][k] - v).abs().max()) <= REL * scale, (t, k)


def test_pull_follows_scatter_on_the_card(cuda):
    g = strided_grid()
    pull = engine(g, pull=True)
    assert all(v["strided"] == v["slots"] for d in Direction
               for v in pull_stats(pull, d).values())
    close(pull, engine(g))


def test_captured_pull_follows_eager(cuda):
    g = strided_grid()
    close(engine(g, pull=True), engine(g, pull=True, use_jit=False))


def test_strided_pull_repeats_bit_for_bit(cuda):
    g = strided_grid()
    a, b = engine(g, pull=True), engine(g, pull=True)
    la, lb = flatten(a.state)[0], flatten(b.state)[0]
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert a.lower_bound() == b.lower_bound()
