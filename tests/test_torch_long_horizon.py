"""The long route at 300 knots in both packages: 300 knots of 0.3 m hold
90 m of the 120 m routes (``scenarios.long_route_arrays``), so both
truncate every lane at its last knot (``horizon_truncated``) and solve it.
That is what ``chip_smoke``'s ``n_knots_300`` run holds on the card, where
the long route's other runs hold that no lane but the blocked one is
truncated.
"""

import jax
import numpy as np

from tpu_pathopt import pipeline as jpipe
from tpu_pathopt.config import PlannerConfig as JaxConfig
from tpu_pathopt_torch import golden, pipeline, scenarios
from tpu_pathopt_torch.config import PlannerConfig

from test_torch_fixtures import jax_scenarios
from test_torch_long_stretch import jax_map


def test_both_packages_truncate_every_lane_at_300_knots():
    """At 300 knots of 0.3 m the horizon holds 90 m of the 120 m routes:
    the JAX package (its XLA path) and the port truncate every lane, one
    of each lane class here, at its last knot, and solve it."""
    lanes = [16, 80, 144, 208]
    arrays = {k: v[lanes] for k, v in
              scenarios.long_route_arrays(256).items()}
    kw = dict(scenarios.LONG_CONFIG, n_knots=300)
    jres = jpipe.solve_batch_jit(jax_map(), jax_scenarios(arrays),
                                 JaxConfig(**kw))
    gm, _ = golden.fixture_batch("long", "cpu")
    res = pipeline.solve_batch(gm, scenarios.scenario_batch(arrays, "cpu"),
                               PlannerConfig(**kw), device="cpu")
    for r in (res, jax.tree_util.tree_map(np.asarray, jres)):
        assert np.asarray(r.ok).all()
        assert np.asarray(r.horizon_truncated).all()
        assert (np.asarray(r.n_valid) == 300).all()
