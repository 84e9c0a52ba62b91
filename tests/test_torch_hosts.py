"""The port's own copies of the JAX package's host modules, pinned bit for
bit to the originals on seeded inputs: config, the KEMAR grid and
``pick_hrtf``, ``synthetic_database``, the interpolation setup, the spatial
conversions, the trajectories, ``render_oracle``, and the database carried
across by ``convert.database_from_numpy``.

The JAX package's ``pick_hrtf`` and ``interpolation_calculations`` take
its native extension where it is built; the copies are the NumPy forms,
which tests/test_native.py pins to the extension.
"""

import dataclasses

import numpy as np
import pytest

from jefferson_tpu import config as jconfig
from jefferson_tpu.hrtf import kemar as jkemar
from jefferson_tpu.oracle.reference import render_oracle as j_render_oracle
from jefferson_tpu.trajectory import interpolation as jinterp
from jefferson_tpu.trajectory import spatial as jspatial
from jefferson_tpu.trajectory import trajectory as jtraj
from jefferson_tpu_torch import config as tconfig
from jefferson_tpu_torch.convert import database_from_numpy
from jefferson_tpu_torch.hrtf import kemar as tkemar
from jefferson_tpu_torch.oracle.reference import render_oracle as t_render_oracle
from jefferson_tpu_torch.trajectory import interpolation as tinterp
from jefferson_tpu_torch.trajectory import spatial as tspatial
from jefferson_tpu_torch.trajectory import trajectory as ttraj


def _equal(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("fields", [{}, {"frames_per_buffer": 96, "hrtf_len": 256},
                                    {"sample_rate": 48_000, "distance_scale": 2.0}])
def test_config_is_equal(fields):
    got, want = tconfig.EngineConfig(**fields), jconfig.EngineConfig(**fields)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("pad_len", "num_bins", "history_len", "block_duration", "fsvs"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert dataclasses.asdict(tconfig.DEFAULT_CONFIG) == dataclasses.asdict(jconfig.DEFAULT_CONFIG)
    assert {p.name: int(p) for p in tconfig.ProcessType} == {p.name: int(p) for p in jconfig.ProcessType}
    assert [p.is_oracle for p in tconfig.ProcessType] == [p.is_oracle for p in jconfig.ProcessType]
    with pytest.raises(ValueError):
        tconfig.EngineConfig(frames_per_buffer=1)


def test_kemar_grid_is_equal():
    for name in ("ELEVATIONS", "AZIMUTH_INC", "AZIMUTH_COUNTS", "AZIMUTH_OFFSET"):
        _equal(getattr(tkemar, name), getattr(jkemar, name), name)
    assert tkemar.NUM_HRTF == jkemar.NUM_HRTF == 710
    for g, w in zip(tkemar.AZIMUTH_GRIDS, jkemar.AZIMUTH_GRIDS):
        _equal(g, w)
    assert [tkemar.grid_position(i) for i in range(710)] == [jkemar.grid_position(i) for i in range(710)]


def test_round_half_away_and_pick_hrtf_are_equal():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-500, 500, 2000), np.arange(-10, 10, 0.5),
                        [0.49999997, -0.49999997, 354.5, -0.5]]).astype(np.float32)
    _equal(tkemar.round_half_away(x), jkemar.round_half_away(x))
    ele = np.concatenate([rng.uniform(-50, 100, 3000), np.arange(-45, 95, 5.0)]).astype(np.float32)
    azi = np.concatenate([rng.uniform(-20, 380, 3000), np.arange(0, 420, 15.0)[: len(ele) - 3000]
                          ]).astype(np.float32)
    azi = np.resize(azi, ele.shape)
    _equal(tkemar.pick_hrtf(ele, azi), jkemar.pick_hrtf(ele, azi))
    assert tkemar.pick_hrtf(10.0, 354.0) == jkemar.pick_hrtf(10.0, 354.0)


@pytest.mark.parametrize("fields,n_taps,seed", [({}, None, 1234), ({"frames_per_buffer": 96,
                                                                    "hrtf_len": 256}, 256, 9)])
def test_synthetic_database_is_equal(fields, n_taps, seed):
    got = tkemar.synthetic_database(tconfig.EngineConfig(**fields), n_taps=n_taps, seed=seed)
    want = jkemar.synthetic_database(jconfig.EngineConfig(**fields), n_taps=n_taps, seed=seed)
    _equal(got.hrirs, want.hrirs, "hrirs")
    _equal(got.spectra, want.spectra, "spectra")
    assert got.source == want.source and got.num_hrtf == want.num_hrtf
    with pytest.raises(ValueError):
        tkemar.HRTFDatabase.from_hrirs(np.zeros((3, 1, 8), np.float32))


def test_database_from_numpy_carries_the_jax_database(db):
    got = database_from_numpy(db.spectra, db.hrirs, dataclasses.asdict(db.config))
    assert isinstance(got, tkemar.HRTFDatabase) and isinstance(got.config, tconfig.EngineConfig)
    assert dataclasses.asdict(got.config) == dataclasses.asdict(db.config)
    _equal(got.spectra, db.spectra)
    _equal(got.hrirs, db.hrirs)


def test_interpolation_calculations_are_equal():
    rng = np.random.default_rng(1)
    ele = np.concatenate([rng.uniform(-45, 95, 2000), np.arange(-40, 91, 1.0)]).astype(np.float32)
    azi = np.resize(np.concatenate([rng.uniform(0, 361, 2000), [354.0, 355.0, 359.6, 0.0]]),
                    ele.shape).astype(np.float32)
    for args in ((ele, azi), (ele[:7].reshape(7, 1), azi[:5].reshape(1, 5)), (12.0, 354.0)):
        got, want = tinterp.interpolation_calculations(*args), jinterp.interpolation_calculations(*args)
        for f in ("indices", "weights", "omegas", "case"):
            _equal(getattr(got, f), getattr(want, f), f)


def test_spatial_conversions_are_equal():
    rng = np.random.default_rng(2)
    xyz = np.concatenate([rng.standard_normal((500, 3)) * 3, np.zeros((1, 3))]).astype(np.float32)
    for g, w in zip(tspatial.cartesian_to_spherical(xyz), jspatial.cartesian_to_spherical(xyz)):
        _equal(g, w)
    azi, ele, r = rng.uniform(-30, 400, 500), rng.uniform(-45, 95, 500), rng.uniform(0.05, 4, 500)
    _equal(tspatial.spherical_to_cartesian(azi, ele, r), jspatial.spherical_to_cartesian(azi, ele, r))
    _equal(tspatial.radius_from_cartesian(xyz), jspatial.radius_from_cartesian(xyz))


@pytest.mark.parametrize("name,kwargs", [
    ("StaticPosition", dict(azi=-90.0, ele=10.0, r=0.7)),
    ("CircularOrbit", dict(period_s=0.4, ele=5.0, r=1.0, start_azi=30.0, direction=-1)),
    ("AzimuthSweep", dict(start_azi=3.0, ele=5.0, r=0.5, blocks_per_step=7, num_steps=4)),
])
def test_trajectories_are_equal(name, kwargs):
    got = getattr(ttraj, name)(**kwargs).sample(50)
    want = getattr(jtraj, name)(**kwargs).sample(50)
    _equal(got, want)
    if name == "AzimuthSweep":
        assert ttraj.AzimuthSweep(**kwargs).total_blocks == jtraj.AzimuthSweep(**kwargs).total_blocks
    with pytest.raises(ValueError):
        ttraj.CircularOrbit(period_s=0.0).sample(4)


@pytest.mark.parametrize("initial_old", [(0.0, 0.0), None, (33.0, -10.0)])
def test_render_oracle_is_equal(db, initial_old):
    """Every interpolation case, crossfades and holds, a signal shorter than
    the render (the playhead wraps), and each crossfade start state."""
    rng = np.random.default_rng(3)
    b = 40
    pos = np.stack([np.repeat(rng.uniform(0, 360, b // 4), 4), np.repeat(rng.uniform(-40, 90, b // 4), 4),
                    rng.uniform(0.2, 2.0, b)], axis=1)
    sig = (rng.standard_normal(b * 128 - 300) * 0.3).astype(np.float32)
    tdb = database_from_numpy(db.spectra, db.hrirs, dataclasses.asdict(db.config))
    got = t_render_oracle(sig, tdb, [tuple(p) for p in pos], tdb.config, initial_old=initial_old)
    want = j_render_oracle(sig, db, [tuple(p) for p in pos], db.config, initial_old=initial_old)
    _equal(got, want)
