"""The port's trajectories and ``rms_error`` against the JAX package's.

Every case of tests/test_trajectory.py on the port's classes, each
``sample()`` bit-equal to the JAX class's on the same arguments, and the
``rms_error`` case of tests/test_graft_and_config.py.
"""

import numpy as np
import pytest
import torch

from jefferson_tpu.testing import rms_error as j_rms_error
from jefferson_tpu.trajectory import trajectory as jtraj
from jefferson_tpu_torch.config import DEFAULT_CONFIG as CFG
from jefferson_tpu_torch.testing import rms_error
from jefferson_tpu_torch.trajectory import trajectory as ttraj

torch.set_num_threads(1)


def both(name, *args, **kw):
    """(port trajectory, JAX trajectory) of class ``name``."""
    return getattr(ttraj, name)(*args, **kw), getattr(jtraj, name)(*args, **kw)


def sample(name, blocks, *args, **kw):
    """The port's samples, held bit-equal to the JAX class's."""
    t, j = both(name, *args, **kw)
    got, want = t.sample(blocks, CFG), j.sample(blocks, CFG)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    return got


def test_static():
    pos = sample("StaticPosition", 5, azi=12, ele=-3, r=2.0)
    np.testing.assert_array_equal(pos, np.tile([12, -3, 2.0], (5, 1)))


def test_events_hold_and_order():
    # out-of-order events are sorted; a position holds until the next event
    pos = sample("PositionEvents", 12, [(0.01, 10, 0, 1), (0.0, 0, 0, 1), (0.02, 20, 5, 2)])
    blocks_per_10ms = int(round(0.01 / CFG.block_duration))
    assert pos[0, 0] == 0
    assert pos[blocks_per_10ms + 1, 0] == 10
    assert pos[-1, 0] == 20 and pos[-1, 1] == 5 and pos[-1, 2] == 2


def test_events_before_first():
    pos = sample("PositionEvents", 3, [(1.0, 45, 0, 1)])
    np.testing.assert_array_equal(pos[:, 0], [45, 45, 45])


def test_orbit_direction_and_wrap():
    cw = sample("CircularOrbit", 400, period_s=1.0, start_azi=350)
    assert cw[0, 0] == 350
    assert np.all(cw[:, 0] < 360) and np.all(cw[:, 0] >= 0)
    ccw = sample("CircularOrbit", 10, period_s=1.0, start_azi=10, direction=-1)
    assert ccw[1, 0] < 10


def test_linear_path_holds_endpoint():
    blocks = int(round(0.02 / CFG.block_duration))
    pos = sample("LinearPath", blocks, (0, 0, -1), (1, 0, 0), duration_s=0.01)
    # starts ahead (azi 0), ends right (azi 270 for +x in the reference's axes)
    assert pos[0, 0] == 0
    assert pos[-1, 0] == 270
    np.testing.assert_array_equal(pos[-1], pos[-2])


def test_cartesian_function():
    fn = lambda ts: np.stack([np.zeros_like(ts), np.zeros_like(ts), -1 - ts], -1)  # noqa: E731
    pos = sample("CartesianFunction", 4, fn)
    np.testing.assert_array_equal(pos[:, 0], 0)
    assert pos[-1, 2] > pos[0, 2]


def test_sweep_total_blocks():
    t, j = both("AzimuthSweep", blocks_per_step=3, num_steps=4)
    assert t.total_blocks == j.total_blocks == 15
    pos = sample("AzimuthSweep", 15, blocks_per_step=3, num_steps=4)
    assert len(np.unique(pos[:, 0])) == 5


def test_negative_azimuth_wraps():
    a = sample("StaticPosition", 4, azi=-90.0, ele=0.0, r=1.0)
    b = sample("StaticPosition", 4, azi=270.0, ele=0.0, r=1.0)
    np.testing.assert_array_equal(a, b)
    ev = sample("PositionEvents", 3, [(0.0, -45.0, 10.0, 1.0)])
    assert np.all(ev[:, 0] == 315.0)
    c = sample("StaticPosition", 1, azi=359.7, ele=0.0, r=1.0)
    assert c[0, 0] == 359.7


def test_orbit_zero_period_rejected():
    for cls in both("CircularOrbit", period_s=0.0):
        with pytest.raises(ValueError, match="period_s"):
            cls.sample(4, CFG)
    with pytest.raises(ValueError, match="at least one event"):
        ttraj.PositionEvents([]).sample(2, CFG)


def test_cartesian_trajectory_uses_true_radius():
    """A cartesian drive's radius survives the planner's round trip as the
    true |xyz|, in the port as in the original."""
    from jefferson_tpu_torch.engine.plan import make_plan
    from jefferson_tpu_torch.trajectory.spatial import (
        radius_from_cartesian,
        spherical_to_cartesian,
    )

    xyz_true = np.array([0.3, 1.2, -0.3], np.float64)
    pos = sample("LinearPath", 4, tuple(xyz_true), tuple(xyz_true), 1.0)
    coords = spherical_to_cartesian(pos[:, 0], pos[:, 1], pos[:, 2])
    np.testing.assert_allclose(radius_from_cartesian(coords),
                               float(np.sqrt((xyz_true**2).sum())), rtol=1e-5)
    np.testing.assert_array_equal(ttraj._cartesian_positions(xyz_true[None]),
                                  jtraj._cartesian_positions(xyz_true[None]))
    assert make_plan(pos, CFG).u_hi.shape[0] == 4


@pytest.mark.parametrize("seed", [0, 1])
def test_moving_trajectories_bit_equal_at_length(seed):
    """Longer random flybys, orbits and event lists, bit-equal sample by sample."""
    rng = np.random.default_rng(seed)
    a, b = tuple(rng.uniform(-2, 2, 3)), tuple(rng.uniform(-2, 2, 3))
    sample("LinearPath", 3000, a, b, float(rng.uniform(0.5, 5.0)))
    sample("CircularOrbit", 3000, period_s=float(rng.uniform(0.2, 4.0)),
           ele=float(rng.uniform(-40, 90)), r=1.3, start_azi=float(rng.uniform(0, 360)))
    events = [(float(t), float(az), float(el), 1.0) for t, az, el in
              zip(rng.uniform(0, 5, 20), rng.uniform(-180, 360, 20), rng.uniform(-40, 90, 20))]
    sample("PositionEvents", 3000, events)


def test_rms_error_matches_the_original():
    a = np.array([0.0, 3.0, 4.0])
    assert rms_error(a, np.zeros(3)) == pytest.approx(np.sqrt(25.0 / 3.0))
    rng = np.random.default_rng(5)
    x, y = rng.standard_normal(1000).astype(np.float32), rng.standard_normal(1000)
    assert rms_error(x, y) == j_rms_error(x, y)
