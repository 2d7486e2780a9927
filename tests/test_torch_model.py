"""tests/test_model.py on the port: the end-to-end micro-LP of
test/test_model.{hxx,cpp}, seven binary factors coupled by six equality
messages of a message type written here (the custom-type extension API),
whose optimal lower bound after Solve() is 1.0 (test/test_model.cpp:46).
The test type also gives the LP hook ``lp_coupling``, so the same model
exports to the local polytope, whose LP value is 1.0 too.
"""
import numpy as np
import torch

from lp_mp_tpu_torch import MessageSchedule, Solver, StandardVisitor, solve_lp_relaxation
from lp_mp_tpu_torch.factors.simplex import UNARY_SIMPLEX
from lp_mp_tpu_torch.registry import MessageType, mask_pad


class TestEqualityMessage(MessageType):
    """test_message (test_model.hxx:66-128): marginal = cost - min(cost),
    applied to both sides; schedule left."""

    __test__ = False
    name = "test_equality"
    left_type = UNARY_SIMPLEX
    right_type = UNARY_SIMPLEX
    schedule = MessageSchedule.left()

    def _marg(self, costs):
        c = costs["c"]
        return mask_pad(c - torch.amin(c, dim=1, keepdim=True))

    def marginal_left(self, left_costs, data):
        return self._marg(left_costs)

    def marginal_right(self, right_costs, data):
        return self._marg(right_costs)

    def repam_left(self, costs, idx, delta, data):
        return {**costs, "c": costs["c"].index_add(0, idx, delta)}

    def repam_right(self, costs, idx, delta, data):
        return {**costs, "c": costs["c"].index_add(0, idx, delta)}

    def propagate_primal_l2r(self, left_primal, right_primal, lidx, ridx, data):
        return {**right_primal,
                "x": right_primal["x"].index_put((ridx,), left_primal["x"][lidx])}

    def consistent(self, left_primal, right_primal, lidx, ridx, data):
        l = left_primal["x"][lidx]
        return (l >= 0) & (l == right_primal["x"][ridx])

    def lp_coupling(self, lmeta, rmeta, data):
        return [({lab: 1.0}, {lab: -1.0}, 0.0) for lab in range(lmeta[0])]


MSG = TestEqualityMessage()


def build_test_model(g):
    """build_test_model (test_model.hxx:139-176)."""
    f1 = g.add_factor(UNARY_SIMPLEX, np.array([0.0, 1.0]))
    for first_pair in (False, True, True):
        f2 = g.add_factor(UNARY_SIMPLEX, np.array([1.0, 0.0]))
        f3 = g.add_factor(UNARY_SIMPLEX, np.array([0.0, 0.0]))
        g.add_message(MSG, f1, f2)
        if first_pair:
            g.add_message(MSG, f2, f3)
        else:
            g.add_message(MSG, f1, f3)
    return f1


def test_model_counts():
    s = Solver(device="cpu")
    build_test_model(s.graph)
    assert s.graph.n_factors == 7
    assert len(s.graph.messages) == 6


def test_model_lower_bound():
    for mode in ("sequential", "wavefront"):
        s = Solver(visitor=StandardVisitor(max_iter=100), schedule_mode=mode, device="cpu")
        build_test_model(s.graph)
        lb = s.solve()
        assert abs(lb - 1.0) <= 1e-8, (mode, lb)
        assert abs(s.primal_cost() - 1.0) <= 1e-8


def test_model_lp_export_solves_to_one():
    s = Solver(visitor=StandardVisitor(max_iter=100), device="cpu")
    build_test_model(s.graph)
    s.build_engine()
    lp0 = solve_lp_relaxation(s.engine)
    lb = s.solve()
    assert abs(lp0 - 1.0) <= 1e-9
    assert abs(solve_lp_relaxation(s.engine) - 1.0) <= 1e-9
    assert lb <= lp0 + 1e-9
