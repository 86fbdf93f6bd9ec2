"""repro_torch.core.perf_model vs repro.core.perf_model: every function
exactly equal over a grid of (m, n, k, num, c), the paper's B200 worked
example (140 / 140 / 69 / 73 TFLOP/s), the shared hardware rows equal, and
the port's H100 row present. Tolerance: exact (==), the same float
arithmetic in the same order; the worked example within the reference's
own bands."""
import dataclasses
import itertools

import pytest

from repro.core import perf_model as jpm
from repro_torch.core import perf_model as pm

GRID = list(itertools.product((1, 129, 4096), (7, 1024), (16, 8192, 16384),
                              (3, 6, 7, 13, 16), (0.0, 16, 39.5)))
TIMES = ("t_i8fast", "t_i8acc", "t_f8fast", "t_f8acc")


@pytest.mark.parametrize("name", TIMES)
def test_time_models_equal_reference(name):
    for m, n, k, num, c in GRID:
        args = (m, n, k, num, c, 3.0e15, 4.0e12)
        assert getattr(pm, name)(*args) == getattr(jpm, name)(*args)
        assert (pm.blocked_time(getattr(pm, name), m, n, k, 512, 1024, 2048, num, c, 1e15, 2e12)
                == jpm.blocked_time(getattr(jpm, name), m, n, k, 512, 1024, 2048, num, c,
                                    1e15, 2e12))


def test_workspace_counts_and_predict_equal_reference():
    for m, n, k, num, c in GRID:
        assert pm.m_n(num) == jpm.m_n(num)
        assert pm.w_i8(m, n, k, num) == jpm.w_i8(m, n, k, num)
        assert pm.w_f8(m, n, k, num) == jpm.w_f8(m, n, k, num)
        assert pm.dgemm_equivalent_tflops(m, n, k, c + 1e-3) == \
            jpm.dgemm_equivalent_tflops(m, n, k, c + 1e-3)
        for scheme in ("ozaki2-int8", "ozaki2-fp8", "fp8-hybrid"):
            for mode in ("fast", "accurate"):
                for hw, jhw in ((pm.B200_MEASURED, jpm.B200_MEASURED),
                                (pm.RUBIN_SHEET, jpm.RUBIN_SHEET)):
                    assert pm.predict(scheme, mode, m, n, k, num, hw) == \
                        jpm.predict(scheme, mode, m, n, k, num, jhw)
                    assert pm.predict(scheme, mode, m, n, k, num, hw, c) == \
                        jpm.predict(scheme, mode, m, n, k, num, jhw, c)
    with pytest.raises(ValueError):
        pm.predict("ozaki1-fp8", "fast", 8, 8, 8, 11, pm.B200_MEASURED)


def test_b200_worked_example():
    m = n = k = 16384
    ops, b = 3.0e15, 4.0e12
    got = (pm.dgemm_equivalent_tflops(m, n, k, pm.t_i8fast(m, n, k, 16, 16, ops, b)),
           pm.dgemm_equivalent_tflops(m, n, k, pm.t_i8acc(m, n, k, 15, 16, ops, b)),
           pm.dgemm_equivalent_tflops(m, n, k, pm.t_f8fast(m, n, k, 13, 39, ops, b)),
           pm.dgemm_equivalent_tflops(m, n, k, pm.t_f8acc(m, n, k, 12, 37, ops, b)))
    for value, paper, band in zip(got, (140, 140, 69, 73), (5, 5, 4, 4)):
        assert abs(value - paper) < band, got


def test_hardware_rows():
    for name in ("B200-measured", "Rubin-sheet"):
        assert dataclasses.asdict(pm.HARDWARE[name]) == dataclasses.asdict(jpm.HARDWARE[name])
    h100 = pm.HARDWARE["H100-SXM-sheet"]
    assert h100 is pm.H100_SXM_SHEET
    assert (h100.ops_i8, h100.ops_f8, h100.bandwidth, h100.peak_fp64) == (
        1979e12 * 0.6, 1979e12 * 0.6, 3.35e12 * 0.5, 67e12)
    assert not any(name.startswith("TPU") for name in pm.HARDWARE)
    # the H100 sheet row predicts the 8-bit emulation below its FP64 peak at 8192^3
    assert 0 < pm.predict("ozaki2-fp8", "accurate", 8192, 8192, 8192, 12, h100) < 67
