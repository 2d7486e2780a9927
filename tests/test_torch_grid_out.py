"""The dense grid kernel wrappers' ``out=`` and ``GridPottsModel.run_fast``'s
buffers, on the CPU.

The dense wrappers (``phase_update``, ``phase_update_v1``, ``round_update``,
``launch_round_update``) take ``out=`` as the sharded ones do: a state dict
that the launch writes in place, checked for shape, dtype, device and
contiguity and refused where it shares memory with an input.  The CPU route
(the plain versions) honours it the same way.  ``run_fast(kernel="cuda")``
writes its launches through two scratch sets owned by the model and ends in
the state's own tensors; it must give the same state with ``use_jit`` on and
off, the plain path's state, and the JAX package's.  Tolerances: 0 between
the port's own paths (the same operations), 1e-10 against the JAX package
in float64.
"""
import numpy as np
import pytest
import torch

from lp_mp_tpu.models.grid_potts import GridPottsModel as JaxGrid
from lp_mp_tpu_torch import GridPottsModel, random_grid
from lp_mp_tpu_torch.kernel_check import PHASE_PARAMS, random_dense_state
from lp_mp_tpu_torch.ops import grid_kernels as gk

MODES = ["anisotropic", "uniform", "damped_uniform"]
V1 = torch.tensor([2, 2, 10], dtype=torch.int32)
# (name, call(state, hc, vc, out=...)) of every dense wrapper with a CPU route
WRAPPERS = [(f"phase_update{p}", lambda s, hc, vc, p=p, **kw: gk.phase_update(s, hc, vc, *p, **kw))
            for p in PHASE_PARAMS]
WRAPPERS += [("phase_update_v1", lambda s, hc, vc, **kw: gk.phase_update_v1(V1, s, hc, vc, **kw)),
             ("round_update 1", lambda s, hc, vc, **kw: gk.round_update(s, hc, vc, 1, **kw)),
             ("round_update 2", lambda s, hc, vc, **kw: gk.round_update(s, hc, vc, 2, **kw))]


def fresh_out(state):
    return {k: torch.full_like(state[k], float("nan")) for k in gk.STATE_KEYS}


@pytest.mark.parametrize("name,call", WRAPPERS, ids=[w[0] for w in WRAPPERS])
def test_dense_wrappers_write_into_out(name, call):
    state, hc, vc = random_dense_state(7, 9, 3, seed=4)
    before = {k: v.clone() for k, v in state.items()}
    want = call(state, hc, vc)
    out = fresh_out(state)
    ptrs = {k: out[k].data_ptr() for k in gk.STATE_KEYS}
    got = call(state, hc, vc, out=out)
    assert got is out
    for k in gk.STATE_KEYS:
        assert out[k].data_ptr() == ptrs[k], k
        assert torch.equal(out[k], want[k]), k
        assert torch.equal(state[k], before[k]), k       # the inputs stay as they were


@pytest.mark.parametrize("name,call", WRAPPERS + [
    ("launch_round_update", lambda s, hc, vc, **kw: gk.launch_round_update(s, hc, vc, 2, **kw))],
    ids=[w[0] for w in WRAPPERS] + ["launch_round_update"])
def test_dense_wrappers_refuse_a_bad_out(name, call):
    """An ``out`` that shares memory with an input, or does not fit the
    state, is refused before anything runs (``launch_round_update``, the
    CUDA-only entry, checks before it launches)."""
    state, hc, vc = random_dense_state(7, 9, 1, seed=5)
    for k in gk.STATE_KEYS:
        with pytest.raises(ValueError, match="shares memory"):
            call(state, hc, vc, out={**fresh_out(state), k: state[k]})
    # a cost array seen through a state-shaped view (L = 1) is an input too
    with pytest.raises(ValueError, match="shares memory"):
        call(state, hc, vc, out={**fresh_out(state), "hm2": hc.view(1, 7, 8)})
    with pytest.raises(ValueError, match="contiguous"):
        call(state, hc, vc, out={**fresh_out(state), "u": torch.zeros(1, 7, 8)})
    with pytest.raises(ValueError, match="contiguous"):
        call(state, hc, vc, out={**fresh_out(state), "vm1": fresh_out(state)["vm1"].double()})
    wide = torch.zeros(1, 9, 7).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        call(state, hc, vc, out={**fresh_out(state), "u": wide})


def test_sharded_cpu_route_refuses_aliased_out():
    from lp_mp_tpu_torch.parallel.grid import RowShards
    state, hc, vc = random_dense_state(12, 9, 3, seed=0)
    lay = RowShards(12, 9, ["cpu"] * 2)
    w, c = lay.split(state), lay.split_costs(hc, vc)
    s, cs = lay.slabs(w), lay.slabs(c)
    args = (w[0], s[0], c[0]["hc"], c[0]["vc"], cs[0], 0, 12, 9)
    with pytest.raises(ValueError, match="shares memory"):
        gk.phase_update_sharded(*args, 1, 1, 0.0, out=w[0])
    with pytest.raises(ValueError, match="shares memory"):
        gk.round_update_sharded(*args, 2, out={**fresh_out(w[0]), "u": w[0]["u"]})


def test_sharded_launch_refuses_a_bad_out_before_launching():
    """``launch_round_update_sharded``, the CUDA-only entry of the sharded
    round kernel at a given geometry, checks ``out`` before it launches."""
    from lp_mp_tpu_torch.parallel.grid import RowShards
    state, hc, vc = random_dense_state(12, 9, 3, seed=0)
    lay = RowShards(12, 9, ["cpu"] * 2)
    w, c = lay.split(state), lay.split_costs(hc, vc)
    s, cs = lay.slabs(w), lay.slabs(c)
    args = (w[1], s[1], c[1]["hc"], c[1]["vc"], cs[1], lay.row0[1], 12, 9, 2)
    with pytest.raises(ValueError, match="shares memory"):
        gk.launch_round_update_sharded(*args, tile=(3, 4), out={**fresh_out(w[1]), "vm2": w[1]["vm2"]})
    with pytest.raises(ValueError, match="contiguous"):
        gk.launch_round_update_sharded(*args, out={**fresh_out(w[1]), "u": torch.zeros(3, 5, 9)})


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [0, 1, 2, 3])
def test_run_fast_use_jit_on_and_off_are_equal(mode, n):
    """Twice run_fast(n): the captured call (direct on the CPU, the same
    buffer logic) and the eager one give the same state, bit for bit, and
    the plain path's; the state keeps its tensors."""
    u, hc, vc = random_grid(7, 8, 3, seed=n + 3)
    on, off = (GridPottsModel(u, hc, vc, device="cpu", use_jit=j) for j in (True, False))
    plain = GridPottsModel(u, hc, vc, device="cpu", use_jit=False)
    ids = {k: id(v) for k, v in on.state.items()}
    for _ in range(2):
        on.run_fast(n, mode, kernel="cuda")
        off.run_fast(n, mode, kernel="cuda")
        plain.run_fast(n, mode, kernel="torch")
        for k in gk.STATE_KEYS:
            assert torch.equal(on.state[k], off.state[k]), k
            assert torch.equal(on.state[k], plain.state[k]), k
    assert {k: id(v) for k, v in on.state.items()} == ids
    assert on.lower_bound() == off.lower_bound()


def test_load_state_never_aliases_the_callers_tensors():
    u, hc, vc = random_grid(5, 6, 2, seed=1)
    src = GridPottsModel(u, hc, vc, device="cpu", use_jit=False).run_fast(2)
    keep = {k: v.clone() for k, v in src.state.items()}
    m = GridPottsModel(u, hc, vc, device="cpu", use_jit=False).load_state(src.state)
    m.run_fast(3, "uniform")
    for k in gk.STATE_KEYS:
        assert torch.equal(src.state[k], keep[k]), k


@pytest.mark.parametrize("mode", MODES)
def test_run_fast_matches_jax(mode):
    """The port's kernel schedule (plain versions on the CPU) against the
    JAX package's run_fast in float64, over calls of n = 0, 1, 2 and 3."""
    u, hc, vc = random_grid(9, 10, 3, seed=17)
    jm = JaxGrid(u, hc, vc, dtype=np.float64)
    pm = GridPottsModel(u, hc, vc, device="cpu", dtype=torch.float64)
    for n in (0, 1, 2, 3):
        jm.run_fast(n, mode=mode, kernel="xla")
        pm.run_fast(n, mode=mode, kernel="cuda")
        for k in gk.STATE_KEYS:
            np.testing.assert_allclose(np.asarray(jm.state[k]), pm.state[k].numpy(), rtol=0,
                                       atol=1e-10, err_msg=f"{mode} n={n} {k}")
        assert abs(jm.lower_bound() - pm.lower_bound()) < 1e-9


def test_capture_warm_up_runs_on_copies_of_the_donated_state():
    """run_fast's kernel schedule writes the state's own tensors, so the
    warm-up run before a CUDA-graph capture must not touch them: it gets
    clones of the donated arguments (the other arguments as they are)."""
    from lp_mp_tpu_torch.capture import Graphed, Graphs, flatten
    owner = Graphs("cpu", name="test")
    g = Graphed(owner, lambda s, c: (s, None), "f", donate=(0,))
    state, cost = {"u": torch.ones(3), "v": torch.zeros(2)}, torch.arange(4.0)
    leaves, struct = flatten((state, cost))
    entry = g._new_entry((state, cost), leaves, struct)
    warm_state, warm_cost = Graphed.warmup_args(entry)
    for k in state:
        assert warm_state[k] is not entry.static_in[list(state).index(k)]
        assert torch.equal(warm_state[k], state[k])
    assert warm_cost is entry.static_in[-1]
