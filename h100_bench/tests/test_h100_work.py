"""The frozen bytes and operations of K2 give the known counts."""

from h100_bench.metrics import _work


def test_k2_work_at_the_default_shape():
    args = _work.admm_round_args(128, 256, 25)
    nbytes, flops = _work.work("fused_admm_round", args)
    # inputs 136 N B + 11 B floats, outputs 18 N B + 8 B
    assert nbytes == 4 * (154 * 128 * 256 + 19 * 256) == 20_204_544
    # per knot and iteration 400 operations, 160 for the residuals
    assert flops == 128 * 256 * (25 * 400 + 160) == 332_922_880
    ms, by = _work.bound_ms("fused_admm_round", args)
    assert by == "bytes" and abs(ms - 20_204_544 / 3.35e12 * 1e3) < 1e-12


def test_k1_work_at_the_path_qp_shape():
    nbytes, flops = _work.work("fused_factor", (_work.Shape(128, 6, 6, 256),))
    assert nbytes == (128 * 21 + 127 * 36 + 2 * 128 * 36) * 256 * 4
    assert flops == 128 * 256 * _work._factor_flops(6)
