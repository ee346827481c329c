"""The plain reference against NumPy float64 at tiny sizes."""

import math

import numpy as np
import pytest
import torch

from cardbench.references.sum_allreduce import UNIT, compare


def _operands(seed, shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in shapes]


def _numpy_sum(x):
    s = x.numpy().astype(np.float64).sum(0)
    return torch.from_numpy(np.tile(s.astype(np.float32), (x.shape[0], 1)))


@pytest.mark.parametrize("block", [1, 7, 1 << 22])
def test_rounded_float64_sum_reads_within_half_a_unit(block):
    xs = _operands(0, [(8, 33), (8, 1000), (3, 5)])
    out = [_numpy_sum(x) for x in xs]
    got = compare(xs, out, block=block)
    assert got["rank_mismatch"] == 0.0
    # one rounding of the sum: at most half an ulp of |sum| <= sum |x|
    assert 0.0 < got["sum_err_u"] <= 1.0


def test_gap_in_units_matches_a_hand_computation():
    x = torch.tensor([[1.0, 2.0], [3.0, -4.0]])
    out = torch.tensor([[4.0, -2.0], [4.0, -2.0]])
    out[1, 1] = -2.0 + 6.0 * UNIT * 8  # 8 units of u * (2 + 4)
    out[0, 1] = out[1, 1]
    assert compare([x], [out])["sum_err_u"] == pytest.approx(8.0, rel=1e-6)


def test_a_rank_that_differs_is_counted():
    xs = _operands(1, [(8, 64)])
    out = _numpy_sum(xs[0])
    up, down = np.float32(np.inf), np.float32(-np.inf)
    out[5, 3] = float(np.nextafter(np.float32(out[5, 3].item()), up))
    out[2, 3] += 0.0
    out[7, 10] = float(np.nextafter(np.float32(out[7, 10].item()), down))
    assert compare(xs, [out])["rank_mismatch"] == 2.0


def test_wrong_shape_dtype_or_nan_reads_infinitely_far():
    xs = _operands(2, [(8, 16)])
    good = _numpy_sum(xs[0])
    assert compare(xs, [good[:, :8]])["sum_err_u"] == math.inf
    assert compare(xs, [good.double()])["sum_err_u"] == math.inf
    bad = good.clone()
    bad[0, 0] = float("nan")
    got = compare(xs, [bad])
    assert got["sum_err_u"] == math.inf and got["rank_mismatch"] == 1.0


def test_one_rank_only_reads_far_off():
    xs = _operands(3, [(8, 256)])
    assert compare(xs, [xs[0].clone()])["sum_err_u"] > 1e5
