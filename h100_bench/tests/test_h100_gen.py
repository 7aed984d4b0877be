"""The benchmark's frozen traffic generator gives the port's own scenario
arrays and maps bit for bit."""

import numpy as np
import pytest

from h100_bench.gen import scenarios as gen
from tpu_pathopt_torch import scenarios


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 4100000001])
@pytest.mark.parametrize("name", ["adversarial_arrays", "long_route_arrays"])
def test_arrays_equal_the_ports(name, seed):
    a = getattr(gen, name)(256, seed)
    b = getattr(scenarios, name)(256, seed)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_masks_equal_the_ports():
    assert np.array_equal(gen.adversarial_mask(), scenarios.adversarial_mask())
    assert np.array_equal(gen.long_route_mask(), scenarios.long_route_mask())
