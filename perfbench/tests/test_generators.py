"""The world generators give the same inputs for the same seed, and every
seed the same sizes."""
import numpy as np
import pytest

from perfbench.tests import tiny
from perfbench.tlbref import worlds

BIG = 2 ** 31 + 99


@pytest.mark.parametrize("kind", worlds.SYNTH_KINDS)
def test_world_same_seed_same_world(kind):
    name = f"synth-{kind}"
    a = worlds.build_world(name, 1 << 12, 2000, BIG, BIG + 1)
    b = worlds.build_world(name, 1 << 12, 2000, BIG, BIG + 1)
    c = worlds.build_world(name, 1 << 12, 2000, BIG + 1, BIG + 2)
    assert np.array_equal(a.trace, b.trace)
    assert np.array_equal(a.mapping.ppn, b.mapping.ppn)
    assert a.histogram == b.histogram
    assert a.trace.shape == c.trace.shape == (2000,)
    assert (a.mapping.ppn >= 0).sum() == (c.mapping.ppn >= 0).sum() == 4096
    assert not np.array_equal(a.trace, c.trace)
    assert not a.trace.flags.writeable


def test_sweep_seeds_take_large_numbers():
    drv = tiny.driver(tiny.sweep_cell())
    assert drv.seeds(1) == (1, 2)           # Table 4's own seeds
    m, t = drv.seeds(2 ** 33 + 5)
    assert 0 <= m < 2 ** 32 and t == m + 1


def test_unknown_world_is_refused():
    with pytest.raises(ValueError):
        worlds.build_world("mt-churn", 1 << 10, 10, 1, 2)
