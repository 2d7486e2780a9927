"""The port's factor and message types against the JAX package's, on random
batches (mirrors tests/test_messages.py and
tests/test_restricted_rounding.py:47-104).

Blocks are built by both packages' ``build`` from the same numpy instances,
with mixed label counts so padded lanes take part, and with integer
(tie-rich) or normal costs.  Every batched function of every ported type
(bounds, primal argmin and evaluation, marginals, restricted marginals,
reparametrization scatters with duplicate indices, primal propagation and
consistency) is compared in float64 to 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lp_mp_tpu.factors.potts as jpotts
import lp_mp_tpu.factors.simplex as jsimplex
import lp_mp_tpu.messages.pairwise_triplet as jtrip
import lp_mp_tpu.messages.simplex_marginalization as jsm
import lp_mp_tpu_torch.factors.potts as ppotts
import lp_mp_tpu_torch.factors.simplex as psimplex
import lp_mp_tpu_torch.messages.pairwise_triplet as ptrip
import lp_mp_tpu_torch.messages.simplex_marginalization as psm
from lp_mp_tpu.registry import RESTRICT_BIG as J_BIG, mask_pad as j_mask_pad
from lp_mp_tpu_torch.registry import RESTRICT_BIG, mask_pad

TOL = 1e-12
FACTORS = {"unary": (jsimplex.UNARY_SIMPLEX, psimplex.UNARY_SIMPLEX),
           "pairwise": (jsimplex.PAIRWISE_SIMPLEX, psimplex.PAIRWISE_SIMPLEX),
           "ternary": (jsimplex.TERNARY_SIMPLEX, psimplex.TERNARY_SIMPLEX),
           "potts": (jpotts.PAIRWISE_POTTS, ppotts.PAIRWISE_POTTS)}
MESSAGES = {"unary_pairwise_1": (jsm.UNARY_PAIRWISE_1, psm.UNARY_PAIRWISE_1),
            "unary_pairwise_2": (jsm.UNARY_PAIRWISE_2, psm.UNARY_PAIRWISE_2),
            "unary_potts_1": (jsm.UNARY_POTTS_1, psm.UNARY_POTTS_1),
            "unary_potts_2": (jsm.UNARY_POTTS_2, psm.UNARY_POTTS_2),
            "pairwise_triplet_12": (jtrip.PAIRWISE_TRIPLET_12, ptrip.PAIRWISE_TRIPLET_12),
            "pairwise_triplet_13": (jtrip.PAIRWISE_TRIPLET_13, ptrip.PAIRWISE_TRIPLET_13),
            "pairwise_triplet_23": (jtrip.PAIRWISE_TRIPLET_23, ptrip.PAIRWISE_TRIPLET_23)}
KIND_OF = {"unary_simplex": "unary", "pairwise_simplex": "pairwise",
           "ternary_simplex": "ternary", "pairwise_potts": "potts"}
COSTS = ["ties", "normal"]


def costs(rng, shape, kind):
    if kind == "ties":
        return rng.integers(-1, 2, size=shape).astype(np.float64)
    return rng.normal(size=shape)


def instances(rng, fkind, F, kind, L=None):
    """Per-instance data with label counts 2..4 (or all L)."""
    def n():
        return int(L) if L is not None else int(rng.integers(2, 5))
    if fkind == "unary":
        return [costs(rng, (n(),), kind) for _ in range(F)]
    if fkind == "pairwise":
        return [costs(rng, (n(), n()), kind) for _ in range(F)]
    if fkind == "ternary":
        return [costs(rng, (n(), n(), n()), kind) for _ in range(F)]
    return [(n(), float(costs(rng, (), kind))) for _ in range(F)]


def twin_blocks(rng, fkind, F, kind, L=None):
    """Numpy block built by both packages (asserted equal), as (jax, torch)."""
    jt, pt = FACTORS[fkind]
    data = instances(rng, fkind, F, kind, L)
    jb, pb = jt.build(data), pt.build(data)
    assert jb.keys() == pb.keys()
    for k in jb:
        np.testing.assert_array_equal(np.asarray(jb[k]), pb[k])
        assert np.asarray(jb[k]).dtype == pb[k].dtype, k
    if fkind == "potts":        # reparametrized slots, on valid lanes only
        nl = pb["nl"]
        for key in ("msg1", "msg2"):
            lanes = np.arange(pb[key].shape[1])[None, :] < nl[:, None]
            pb[key] = np.where(lanes, costs(rng, pb[key].shape, kind), pb[key])
    return ({k: jnp.asarray(v) for k, v in pb.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in pb.items()})


def random_primal(rng, block, keys, width_of):
    """Labels in -1..L-1 (unset = -1) per primal key, as (jax, torch)."""
    F = next(iter(block.values())).shape[0]
    p = {k: rng.integers(-1, width_of(k), size=F).astype(np.int32) for k in keys}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def close(j, p, tol=TOL):
    j, p = np.asarray(j), p.detach().cpu().numpy()
    assert j.shape == p.shape
    if np.issubdtype(j.dtype, np.floating):
        np.testing.assert_allclose(p, j, rtol=0, atol=tol)
    else:
        np.testing.assert_array_equal(p, j)


def close_tree(j, p):
    assert j.keys() == p.keys()
    for k in j:
        close(j[k], p[k])


def primal_keys(fkind):
    return {"unary": ["x"], "pairwise": ["x1", "x2"], "potts": ["x1", "x2"],
            "ternary": ["x1", "x2", "x3"]}[fkind]


def label_width(block, fkind):
    if fkind == "potts":
        return lambda k: block["msg1"].shape[1]
    c = block["c"]
    return lambda k: c.shape[1] if k == "x" else c.shape[int(k[1])]


# ---------------------------------------------------------------------------
# factor types
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", COSTS)
@pytest.mark.parametrize("fkind", list(FACTORS))
def test_factor_type_matches_jax(fkind, kind):
    rng = np.random.default_rng(3)
    jt, pt = FACTORS[fkind]
    jb, pb = twin_blocks(rng, fkind, 9, kind)
    close(jt.lower_bound(jb), pt.lower_bound(pb))
    close(jt.dual_vector(jb), pt.dual_vector(pb))
    close_tree(jt.init_primal(jb), pt.init_primal(pb))
    jp, pp = random_primal(rng, pb, primal_keys(fkind), label_width(pb, fkind))
    cj, cp = jt.compute_primal(jb, jp), pt.compute_primal(pb, pp)
    close_tree(cj, cp)
    close(jt.evaluate_primal(jb, cj), pt.evaluate_primal(pb, cp))
    close(jt.evaluate_primal(jb, jp), pt.evaluate_primal(pb, pp))     # +inf where unset
    fresh_j = jt.compute_primal(jb, jt.init_primal(jb))
    fresh_p = pt.compute_primal(pb, pt.init_primal(pb))
    close_tree(fresh_j, fresh_p)


def test_unary_argmin_takes_first_of_tied_labels():
    c = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, 0.0], [2.0, 1.0, 1.0]], dtype=torch.float64)
    block = {"c": c, "nl": torch.full((3,), 3, dtype=torch.int32)}
    x = psimplex.UNARY_SIMPLEX.compute_primal(block, psimplex.UNARY_SIMPLEX.init_primal(block))
    assert x["x"].tolist() == [1, 0, 1]


@pytest.mark.parametrize("diff", [1.0, -1.0])
def test_potts_equals_dense(diff):
    """test/potts_factor.cpp:50-55 and tests/test_messages.py:61-71 on the port."""
    msg1, msg2 = np.array([-0.1, 0.5, 0.8]), np.array([1.5, 1.0, 0.0])
    pb = ppotts.PAIRWISE_POTTS.build([(3, diff)])
    pb["msg1"][0] += msg1
    pb["msg2"][0] += msg2
    dense = diff * (1.0 - np.eye(3)) + msg1[:, None] + msg2[None, :]
    db = psimplex.PAIRWISE_SIMPLEX.build([dense])
    pt = {k: torch.from_numpy(v) for k, v in pb.items()}
    dt = {k: torch.from_numpy(v) for k, v in db.items()}
    close(psimplex.PAIRWISE_SIMPLEX.lower_bound(dt).numpy(), ppotts.PAIRWISE_POTTS.lower_bound(pt))
    close(torch.amin(dt["c"], dim=2).numpy(), ppotts.PairwisePottsType.marginal(pt, 1))
    close(torch.amin(dt["c"], dim=1).numpy(), ppotts.PairwisePottsType.marginal(pt, 2))


def test_pinned_pairwise_marginals():
    """test/simplex_marginalization.cpp:26-41 values (tests/test_messages.py:20-33)."""
    cost = np.array([[0.1, 0.2, 0.05], [0.3, 0.001, 0.2],
                     [-0.3, -0.001, -0.2], [0.3, 0.001, 0.2]])
    block = {k: torch.from_numpy(v) for k, v in psimplex.PAIRWISE_SIMPLEX.build([cost]).items()}
    np.testing.assert_allclose(psm.UNARY_PAIRWISE_1.marginal_right(block, {})[0].numpy(),
                               [0.05, 0.001, -0.3, 0.001])
    np.testing.assert_allclose(psm.UNARY_PAIRWISE_2.marginal_right(block, {})[0].numpy(),
                               [-0.3, -0.001, -0.2])


def test_mask_pad_and_restrict_big_match_jax():
    assert RESTRICT_BIG == J_BIG
    x = np.array([[0.5, 1e20, -1e20, 4.9e19, 5e19, -3.0]])
    close(j_mask_pad(jnp.asarray(x)), mask_pad(torch.from_numpy(x)))
    x32 = torch.tensor(x, dtype=torch.float32)
    assert mask_pad(x32).tolist() == [[0.5, 0.0, 0.0, pytest.approx(4.9e19, rel=1e-6), 0.0, -3.0]]


# ---------------------------------------------------------------------------
# message types
# ---------------------------------------------------------------------------
def message_case(name, kind, seed=0, M=11, F=5):
    """Gathered [M] left/right slices, [F]-row blocks for the scatters with
    duplicate indices, random primals on both sides."""
    rng = np.random.default_rng(seed)
    jm, pm = MESSAGES[name]
    lk, rk = KIND_OF[pm.left_type.name], KIND_OF[pm.right_type.name]
    L = 3 if rk == "potts" else None        # potts pairs share one label count
    c = {}
    c["lj"], c["lp"] = twin_blocks(rng, lk, M, kind, L)
    c["rj"], c["rp"] = twin_blocks(rng, rk, M, kind, L)
    c["Lj"], c["Lp"] = twin_blocks(rng, lk, F, kind, L)
    c["Rj"], c["Rp"] = twin_blocks(rng, rk, F, kind, L)
    c["lxj"], c["lxp"] = random_primal(rng, c["lp"], primal_keys(lk), label_width(c["lp"], lk))
    c["rxj"], c["rxp"] = random_primal(rng, c["rp"], primal_keys(rk), label_width(c["rp"], rk))
    c["LXj"], c["LXp"] = random_primal(rng, c["Lp"], primal_keys(lk), label_width(c["Lp"], lk))
    c["RXj"], c["RXp"] = random_primal(rng, c["Rp"], primal_keys(rk), label_width(c["Rp"], rk))
    idx = rng.integers(0, F, size=M)
    idx[:3] = idx[0]                                    # duplicates accumulate
    c["idxj"], c["idxp"] = jnp.asarray(idx), torch.from_numpy(idx)
    c["ridx"] = rng.permutation(F)[:min(F, M)]          # unique targets for writes
    return jm, pm, c


@pytest.mark.parametrize("kind", COSTS)
@pytest.mark.parametrize("name", list(MESSAGES))
def test_marginals_match_jax(name, kind):
    jm, pm, c = message_case(name, kind)
    close(jm.marginal_left(c["lj"], {}), pm.marginal_left(c["lp"], {}))
    close(jm.marginal_right(c["rj"], {}), pm.marginal_right(c["rp"], {}))
    close(jm.restricted_marginal_left(c["lj"], c["lxj"], {}),
          pm.restricted_marginal_left(c["lp"], c["lxp"], {}))
    close(jm.restricted_marginal_right(c["rj"], c["rxj"], {}),
          pm.restricted_marginal_right(c["rp"], c["rxp"], {}))


@pytest.mark.parametrize("kind", COSTS)
@pytest.mark.parametrize("name", list(MESSAGES))
def test_repams_match_jax(name, kind):
    """Deltas of both sides' marginal widths (fit_width / _fit2 slice or
    pad), scattered with duplicate indices; the input block is left alone."""
    jm, pm, c = message_case(name, kind, seed=1)
    for jdelta, pdelta in ((jm.marginal_right(c["rj"], {}), pm.marginal_right(c["rp"], {})),
                           (jm.marginal_left(c["lj"], {}), pm.marginal_left(c["lp"], {}))):
        before = {k: v.clone() for k, v in c["Lp"].items()}
        close_tree(jm.repam_left(c["Lj"], c["idxj"], jdelta, {}),
                   pm.repam_left(c["Lp"], c["idxp"], pdelta, {}))
        close_tree(jm.repam_right(c["Rj"], c["idxj"], -jdelta, {}),
                   pm.repam_right(c["Rp"], c["idxp"], -pdelta, {}))
        for k in before:
            assert torch.equal(before[k], c["Lp"][k])


@pytest.mark.parametrize("name", list(MESSAGES))
def test_primal_propagation_and_consistency_match_jax(name):
    jm, pm, c = message_case(name, "ties", seed=2)
    F = len(c["ridx"])
    lidx = np.random.default_rng(5).integers(0, F, size=F)
    ridx = c["ridx"]
    args_j = (c["LXj"], c["RXj"], jnp.asarray(lidx), jnp.asarray(ridx), {})
    args_p = (c["LXp"], c["RXp"], torch.from_numpy(lidx), torch.from_numpy(ridx), {})
    close_tree(jm.propagate_primal_l2r(*args_j), pm.propagate_primal_l2r(*args_p))
    close(jm.consistent(*args_j), pm.consistent(*args_p))
    # r2l writes duplicate left rows: parity holds where the written values agree
    uniq = np.unique(lidx, return_index=True)[1]
    args_j = (c["LXj"], c["RXj"], jnp.asarray(lidx[uniq]), jnp.asarray(ridx[uniq]), {})
    args_p = (c["LXp"], c["RXp"], torch.from_numpy(lidx[uniq]), torch.from_numpy(ridx[uniq]), {})
    close_tree(jm.propagate_primal_r2l(*args_j), pm.propagate_primal_r2l(*args_p))


def test_restricted_marginal_pairwise_matches_bruteforce():
    """tests/test_restricted_rounding.py:47-73 on the port."""
    rng = np.random.default_rng(0)
    c = rng.normal(size=(5, 3, 4))
    block = {"c": torch.from_numpy(c), "n1": torch.full((5,), 3, dtype=torch.int32),
             "n2": torch.full((5,), 4, dtype=torch.int32)}
    x1 = torch.tensor([-1, 1, -1, 2, -1], dtype=torch.int32)
    x2 = torch.tensor([-1, -1, 3, 1, -1], dtype=torch.int32)
    mm = psm.UNARY_PAIRWISE_1.restricted_marginal_right(block, {"x1": x1, "x2": x2}, {}).numpy()
    for f in range(5):
        for a in range(3):
            expect = c[f, a, int(x2[f])] if int(x2[f]) >= 0 else c[f, a].min()
            if int(x1[f]) >= 0 and a != int(x1[f]):
                expect += RESTRICT_BIG
            assert mm[f, a] == pytest.approx(expect, rel=1e-12)
