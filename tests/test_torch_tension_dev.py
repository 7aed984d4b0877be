"""The TENSION fixture at ``cartesian_deviation_weight = 0.5``
(``jax_tension_dev_b8.npz``): the JAX package's ``solve_batch`` on the
golden batch under TENSION + DP on its TPU path
(``test_torch_fixtures.jax_tpu_path``), regenerated here and compared with
the stored file (flags and counts exactly, values to float32 round-off).

At the default weight 0 a lateral shift of a straight lane costs the
TENSION QP almost nothing, so the end result moves with the summation
order and ``jax_tension_b8.npz`` is held at l 0.1 m. The weight 0.5 makes
the optimum unique (``tests/test_parity_routes.py:59-68``), so this fixture
is held at the default ``golden.TOLERANCES`` (l 0.05 m), here on the CPU
(``test_torch_variants.py``) and on the card (``chip_smoke.py``,
``golden``)."""

from tpu_pathopt_torch import golden

from test_torch_fixtures import assert_regenerates, jax_variant_arrays


def test_tension_dev_fixture_regenerates_and_is_held_at_the_defaults():
    assert "tension_dev" not in golden.FIXTURE_TOLERANCES
    assert golden.CONFIGS["tension_dev"] == dict(
        smoothing_method="TENSION", cartesian_deviation_weight=0.5)
    want = golden.load(golden.FIXTURES["tension_dev"])
    assert bool(want["ok"].all())
    assert_regenerates(jax_variant_arrays("tension_dev")[0], want)
