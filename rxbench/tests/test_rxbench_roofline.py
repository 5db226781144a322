"""K1's operations, bytes and least time (rxbench/roofline.py), held to
PERF.md's K1 case: NORMAL C2/3, B=128, 9 sweeps checked after every
sweep, bound 0.0631 ms by operations."""
import pytest

from rxbench import roofline
from rxbench.gen.dvbt2.params import CodeRate, FECFrame


def test_edges_of_normal_c2_3():
    # 480 info entries of 360 edges, and two parity edges per check row
    assert roofline.edges(FECFrame.NORMAL, CodeRate.C2_3) == 216000


def test_k1_case_of_perf_md():
    bound, by = roofline.k1_bound_s(FECFrame.NORMAL, CodeRate.C2_3, 128,
                                    sweeps=9, n_checks=9)
    assert by == "operations"
    assert bound * 1e3 == pytest.approx(0.0631, abs=5e-5)


@pytest.mark.parametrize("inv_nvar, sweeps, decodes, want", [
    (79.4, 12 * 64, 64, (12 - 7) * 64),      # 19 dB: first check at 8
    (1995.0, 1 * 64, 64, 64),                # clean: a check every sweep
    (31.6, 8, 1, 1),                         # converged at the floor
])
def test_syndrome_passes(inv_nvar, sweeps, decodes, want):
    assert roofline.checks(sweeps, decodes, inv_nvar) == want


def test_k1_kernel_names():
    assert roofline.is_k1("void (anonymous namespace)::sweep_chunk"
                          "<__nv_bfloat16, false, 10>(float*, ...)")
    assert not roofline.is_k1("void at::native::vectorized_elementwise")


def test_check_schedule_is_the_superstep_s():
    """roofline.py counts the syndrome passes by a copy of the superstep's
    schedule: the copy stays equal to the program's constants."""
    from sdr_receiver_dvb_t2_tpu_torch.rx import superstep
    assert roofline.FLOOR_INV_NVAR == superstep.FLOOR_INV_NVAR
    assert roofline.FLOOR_SWEEPS == superstep.FLOOR_SWEEPS
