"""The kernels' yardstick: bytes and operations counted from the problem."""
import pytest

from benchmark import roofline


def test_a_round_launch_and_a_receiving_phase_move_167_86_mb():
    assert roofline.launch_bytes(1000, 1000, 4, 4, True) / 1e6 == pytest.approx(167.864)


def test_a_send_only_phase_moves_159_87_mb():
    assert roofline.launch_bytes(1000, 1000, 4, 4, False) / 1e6 == pytest.approx(159.872)


def test_bytes_bound_the_launches_at_1000x1000():
    b = roofline.launch_bytes(1000, 1000, 4, 4, True)
    ops = roofline.launch_ops(1000, 1000, 4, 2)
    assert roofline.bound_s(b, ops) == pytest.approx(b / 3.35e12)
    assert ops / 67e12 < 0.1 * b / 3.35e12 + 1e-6
    assert roofline.bound_s(b, ops) * 1e6 == pytest.approx(50.108, abs=1e-3)


def test_the_count_follows_the_shape_not_a_layout():
    # one more label adds one label-plane of each state array, read and written
    d = roofline.launch_bytes(10, 12, 5, 4, True) - roofline.launch_bytes(10, 12, 4, 4, True)
    assert d == 2 * 4 * (10 * 12 + 2 * 10 * 11 + 2 * 9 * 12)
