"""The frozen arithmetic against hand-computed values."""

import pytest

from cardbench import yardstick as y


def test_allreduce_bytes_read_every_operand_write_every_result():
    # 8 ranks x 1 MiB of float32: 8 MiB in, 8 MiB out
    assert y.allreduce_bytes(8, 1 << 18, 4) == 16 << 20


def test_bus_bytes_are_nccl_tests_definition():
    # 2 (W-1)/W * n * b = 2 * 7/8 * 4 MiB
    assert y.allreduce_bus_bytes(8, 1 << 20, 4) == pytest.approx(7 << 20)
    assert y.allreduce_bus_bytes(1, 100, 4) == 0.0


def test_step_sums_its_calls():
    counts = [10, 20, 30]
    assert y.step_bytes(8, counts, 4) == 2 * 8 * 60 * 4
    assert y.step_bus_bytes(8, counts, 4) == pytest.approx(2 * 7 / 8 * 240)


def test_roofline_against_3_35_tb_per_s():
    # 3.35 GB at 3.35 TB/s takes 1 ms: 1 ms is 100%, 2 ms is 50%
    assert y.roofline_pct(3.35e9, 1e-3) == pytest.approx(100.0)
    assert y.roofline_pct(3.35e9, 2e-3) == pytest.approx(50.0)
    assert y.roofline_pct(0, 1.0) is None
    assert y.roofline_pct(1.0, 0.0) is None


def test_p95_inclusive():
    values = [float(i) for i in range(1, 101)]
    # inclusive: position 1 + 0.95 * 99 = 95.05
    assert y.p95(values) == pytest.approx(95.05)
    assert y.p95([3.0]) == 3.0
