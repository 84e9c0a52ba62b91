"""The port's HRTF loaders against the JAX package's, on the same files.

The loader cases of tests/test_hrtf.py (compact mirroring, full and compact
trees agreeing, inconsistent trees refused, format detection) and the 14
cases of tests/test_sofa.py run on the port's ``load_full``,
``load_compact``, ``load_database`` and ``load_sofa``; every database the
port loads has ``hrirs`` and ``spectra`` bit-equal to the JAX loader's on
the same tree or file under ``tmp_path``, and every refusal raises the JAX
loader's error with its message.  The trees and files are written by the
JAX tests' own helpers.
"""

import dataclasses
import re
import warnings

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from jefferson_tpu.hrtf import kemar as jkemar  # noqa: E402
from jefferson_tpu.hrtf import sofa as jsofa  # noqa: E402
from jefferson_tpu_torch.bench import write_compact_tree  # noqa: E402
from jefferson_tpu_torch.config import EngineConfig as TConfig  # noqa: E402
from jefferson_tpu_torch.convert import database_from_numpy  # noqa: E402
from jefferson_tpu_torch.hrtf import kemar as tkemar  # noqa: E402
from jefferson_tpu_torch.hrtf import sofa as tsofa  # noqa: E402
from test_hrtf import _write_fake_kemar  # noqa: E402
from test_sofa import _smooth_field_ir, _write_sofa  # noqa: E402

torch.set_num_threads(1)

CFG = TConfig()
LOADERS = {
    "load_full": (tkemar.load_full, jkemar.load_full),
    "load_compact": (tkemar.load_compact, jkemar.load_compact),
    "load_database": (tkemar.load_database, jkemar.load_database),
    "load_sofa": (tsofa.load_sofa, jsofa.load_sofa),
}


def load(name, path, **kw):
    """The port's database from ``path``, held bit-equal to the JAX
    loader's (warnings included, in order)."""
    port, jax_ = LOADERS[name]
    with warnings.catch_warnings(record=True) as w_port:
        warnings.simplefilter("always")
        got = port(path, CFG, **kw)
    with warnings.catch_warnings(record=True) as w_jax:
        warnings.simplefilter("always")
        want = jax_(path, type(jkemar.DEFAULT_CONFIG)(**dataclasses.asdict(CFG)), **kw)
    assert [str(w.message) for w in w_port] == [str(w.message) for w in w_jax]
    for w in w_port:
        warnings.warn(w.message)
    assert got.hrirs.dtype == want.hrirs.dtype and got.spectra.dtype == want.spectra.dtype
    np.testing.assert_array_equal(got.hrirs, want.hrirs)
    np.testing.assert_array_equal(got.spectra, want.spectra)
    assert got.source == want.source
    return got


def refused(name, path, error, match, **kw):
    """Both loaders refuse ``path`` with the same error and message."""
    port, jax_ = LOADERS[name]
    with pytest.raises(error, match=match) as e_port:
        port(path, CFG, **kw)
    with pytest.raises(error) as e_jax:
        jax_(path, **kw)
    assert str(e_port.value) == str(e_jax.value)


@pytest.fixture(scope="module")
def tdb(db):
    return database_from_numpy(db.spectra, db.hrirs, dataclasses.asdict(db.config))


# ---- KEMAR trees (tests/test_hrtf.py) ------------------------------------------


def test_compact_loader_mirroring(tmp_path):
    root = tmp_path / "compact"
    _write_fake_kemar(root, "compact")
    db = load("load_compact", root)
    assert db.hrirs.shape[0] == 710
    i_front, i90, i270 = tkemar.pick_hrtf(0, 0), tkemar.pick_hrtf(0, 90), tkemar.pick_hrtf(0, 270)
    np.testing.assert_array_equal(db.hrirs[i90, 0], db.hrirs[i270, 1])
    np.testing.assert_array_equal(db.hrirs[i90, 1], db.hrirs[i270, 0])
    assert not np.array_equal(db.hrirs[i_front], db.hrirs[i90])


def test_full_and_compact_agree(tmp_path):
    croot, froot = tmp_path / "compact", tmp_path / "full"
    _write_fake_kemar(croot, "compact")
    _write_fake_kemar(froot, "full")
    dbc = load("load_compact", croot)
    dbf = load("load_full", froot)
    np.testing.assert_array_equal(dbc.hrirs, dbf.hrirs)
    assert load("load_database", croot).source.startswith("compact")
    assert load("load_database", froot).source.startswith("full")


def test_loaders_reject_inconsistent_trees(tmp_path):
    from jefferson_tpu.io.wavio import write_wav

    croot = tmp_path / "compact"
    _write_fake_kemar(croot, "compact")
    bad = croot / "elev0" / "H0e090a.wav"
    write_wav(bad, np.zeros((32, 2), np.float32), 48000, bits=16)  # wrong rate
    refused("load_compact", croot, ValueError, "bad compact HRIR file.*H0e090a")
    write_wav(bad, np.zeros((16, 2), np.float32), 44100, bits=16)  # short
    refused("load_compact", croot, ValueError, "length mismatch.*H0e090a")

    froot = tmp_path / "full"
    _write_fake_kemar(froot, "full")
    badf = froot / "elev0" / "L0e090a.wav"
    write_wav(badf, np.zeros(32, np.float32), 22050, bits=16)
    refused("load_full", froot, ValueError, "bad HRIR file.*L0e090a")
    write_wav(badf, np.zeros(16, np.float32), 44100, bits=16)
    refused("load_full", froot, ValueError, "length mismatch.*L0e090a")


def test_load_database_refuses_an_empty_dir(tmp_path):
    refused("load_database", tmp_path, FileNotFoundError, "no HRTF database")


def test_compact_tree_of_the_synthetic_set(tdb, tmp_path):
    """bench.write_compact_tree's tree (the chip smoke's --hrtf-dir input)
    loads bit-equal in both packages, and the directions it writes
    unmirrored (azimuth <= 180) keep their filters exactly."""
    root = write_compact_tree(tdb, tmp_path / "compact")
    db = load("load_database", root)
    assert db.source == f"compact:{root}"
    own = [i for i in range(tkemar.NUM_HRTF) if tkemar.grid_position(i)[1] <= 180.0]
    np.testing.assert_array_equal(db.hrirs[own], tdb.hrirs[own])


def test_full_filename_matches(tmp_path):
    for ele_i, azi in ((0, np.float32(6.43)), (4, np.float32(355.0)), (13, np.float32(0.0))):
        ele = int(tkemar.ELEVATIONS[ele_i])
        assert (tkemar._full_filename(tmp_path, ele, azi, "L")
                == jkemar._full_filename(tmp_path, ele, azi, "L"))


# ---- SOFA (tests/test_sofa.py) --------------------------------------------------


def _grid():
    eles, azis = zip(*(tkemar.grid_position(i) for i in range(tkemar.NUM_HRTF)))
    return np.asarray(azis), np.asarray(eles)


def test_sofa_roundtrip_exact_grid(tdb, tmp_path):
    path = tmp_path / "grid.sofa"
    _write_sofa(path, tdb.hrirs[:, :, : CFG.hrtf_len], *_grid())
    loaded = load("load_sofa", path)
    np.testing.assert_array_equal(loaded.hrirs, tdb.hrirs)
    np.testing.assert_array_equal(loaded.spectra, tdb.spectra)
    assert loaded.source.startswith("sofa:")


def test_sofa_nearest_snapping(tmp_path):
    taps = np.zeros((4, 2, CFG.hrtf_len), np.float32)
    for i in range(4):
        taps[i, :, i] = 1.0
    path = tmp_path / "sparse.sofa"
    _write_sofa(path, taps, [0.0, 90.0, 180.0, 270.0], [0.0] * 4)
    loaded = load("load_sofa", path, mapping="nearest")
    assert loaded.hrirs[int(tkemar.pick_hrtf(0.0, 90.0)), 0, 1] == 1.0
    assert loaded.hrirs[int(tkemar.pick_hrtf(0.0, 180.0)), 0, 2] == 1.0


def test_load_database_detects_sofa(tdb, tmp_path):
    path = tmp_path / "set.sofa"
    _write_sofa(path, tdb.hrirs[:, :, : CFG.hrtf_len], *_grid())
    np.testing.assert_array_equal(load("load_database", path).hrirs, tdb.hrirs)


def test_sofa_resamples_foreign_rate(tdb, tmp_path):
    from jefferson_tpu_torch.io.resample import resample

    taps = tdb.hrirs[:8, :, : CFG.hrtf_len]
    up = np.stack([np.stack([resample(taps[i, c], CFG.sample_rate, 48000) for c in range(2)])
                   for i in range(8)])
    azis, eles = (a[:8] for a in _grid())
    path = tmp_path / "48k.sofa"
    _write_sofa(path, up, azis, eles, sr=48000.0)
    loaded = load("load_sofa", path)
    assert loaded.hrirs.shape == (710, 2, CFG.pad_len)
    for i in range(8):
        a, b = loaded.hrirs[i, 0, : CFG.hrtf_len], taps[i, 0]
        assert np.linalg.norm(a - b) / (float(np.linalg.norm(b)) or 1.0) < 0.2, i


def test_sofa_rejects_bad_files(tmp_path):
    path = tmp_path / "bad.sofa"
    with h5py.File(path, "w") as f:
        f.create_dataset("other", data=np.zeros(3))
    refused("load_sofa", path, ValueError, "SimpleFreeFieldHRIR")
    path2 = tmp_path / "mono.sofa"
    _write_sofa(path2, np.zeros((2, 1, 64)), [0.0, 90.0], [0.0, 0.0])
    refused("load_sofa", path2, ValueError, "2-receiver")


def _rings():
    mazi, mele = [], []
    for e in (-30.0, 0.0, 30.0, 60.0):
        for a in np.arange(0.0, 360.0, 30.0):
            mazi.append(a)
            mele.append(e)
    return mazi, mele


def _band():
    return [i for i in range(tkemar.NUM_HRTF) if -30.0 <= tkemar.grid_position(i)[0] <= 60.0]


def _truth(idxs, delay=True):
    return np.stack([_smooth_field_ir(tkemar.grid_position(i)[1], tkemar.grid_position(i)[0],
                                      CFG.hrtf_len, delay=delay) for i in idxs])


def test_sofa_interp3_beats_nearest_on_sparse_sets(tmp_path):
    mazi, mele = _rings()
    ir = np.stack([_smooth_field_ir(a, e, CFG.hrtf_len) for a, e in zip(mazi, mele)])
    path = tmp_path / "sparse_field.sofa"
    _write_sofa(path, ir, np.asarray(mazi), np.asarray(mele))
    near = load("load_sofa", path, mapping="nearest")
    intp = load("load_sofa", path, mapping="interp3")
    auto = load("load_sofa", path)
    assert auto.source.endswith(":interp3")
    np.testing.assert_array_equal(auto.hrirs, intp.hrirs)
    idxs = _band()
    truth = _truth(idxs)
    err_n = float(np.sqrt(np.mean((near.hrirs[idxs, :, : CFG.hrtf_len] - truth) ** 2)))
    err_i = float(np.sqrt(np.mean((intp.hrirs[idxs, :, : CFG.hrtf_len] - truth) ** 2)))
    assert err_i < 0.75 * err_n, (err_i, err_n)
    collapsed = sum(
        1 for i, j in zip(idxs, idxs[1:])
        if np.array_equal(near.hrirs[i], near.hrirs[j])
        and not np.allclose(_truth([i])[0], _truth([j])[0])
        and not np.array_equal(intp.hrirs[i], intp.hrirs[j])
    )
    assert collapsed > 50, collapsed


def test_sofa_interp3_halves_error_amplitude_field(tmp_path):
    mazi, mele = _rings()
    ir = np.stack([_smooth_field_ir(a, e, CFG.hrtf_len, delay=False) for a, e in zip(mazi, mele)])
    path = tmp_path / "amp_field.sofa"
    _write_sofa(path, ir, np.asarray(mazi), np.asarray(mele))
    near = load("load_sofa", path, mapping="nearest")
    intp = load("load_sofa", path, mapping="interp3")
    idxs = _band()
    truth = _truth(idxs, delay=False)
    err_n = float(np.sqrt(np.mean((near.hrirs[idxs, :, : CFG.hrtf_len] - truth) ** 2)))
    err_i = float(np.sqrt(np.mean((intp.hrirs[idxs, :, : CFG.hrtf_len] - truth) ** 2)))
    assert err_i < 0.5 * err_n, (err_i, err_n)


def test_sofa_applies_data_delay(tmp_path):
    ir = np.zeros((2, 2, CFG.hrtf_len), np.float64)
    pulse = np.exp(-np.arange(9.0) / 3.0)
    for m in range(2):
        ir[m, 0, 4:13] = 0.6 * pulse
        ir[m, 1, 4:13] = 1.0 * pulse
    path = tmp_path / "delayed.sofa"
    _write_sofa(path, ir, [90.0, 270.0], [0.0, 0.0], delay=[[30.0, 0.0], [0.0, 30.0]])
    loaded = load("load_sofa", path, mapping="nearest")
    g = int(tkemar.pick_hrtf(0.0, 90.0))
    onset_l = int(np.argmax(np.abs(loaded.hrirs[g, 0]) > 1e-6))
    onset_r = int(np.argmax(np.abs(loaded.hrirs[g, 1]) > 1e-6))
    assert (onset_l - onset_r, onset_r) == (30, 4)
    path2, path3 = tmp_path / "delayed_ir.sofa", tmp_path / "nodelay.sofa"
    _write_sofa(path2, ir, [90.0, 270.0], [0.0, 0.0], delay=[[5.0, 5.0]])
    _write_sofa(path3, ir, [90.0, 270.0], [0.0, 0.0])
    np.testing.assert_array_equal(load("load_sofa", path2, mapping="nearest").hrirs,
                                  load("load_sofa", path3, mapping="nearest").hrirs)


def test_sofa_multi_radius_keeps_dominant_shell(tmp_path):
    azis = [0.0, 90.0, 180.0, 270.0]
    ir14 = np.zeros((4, 2, CFG.hrtf_len), np.float32)
    ir14[:, :, 1] = 1.0
    ir30 = np.zeros((3, 2, CFG.hrtf_len), np.float32)
    ir30[:, :, 7] = 1.0
    path = tmp_path / "shells.sofa"
    _write_sofa(path, np.concatenate([ir30, ir14]), azis[:3] + azis, [0.0] * 7,
                radius=[3.0] * 3 + [1.4] * 4)
    with pytest.warns(UserWarning, match="radius|radii|shell"):
        loaded = load("load_sofa", path, mapping="nearest")
    for a in azis:
        g = int(tkemar.pick_hrtf(0.0, a))
        assert loaded.hrirs[g, 0, 1] == 1.0 and loaded.hrirs[g, 0, 7] == 0.0, a


def test_sofa_trims_pathological_time_of_flight(tmp_path):
    tof = 300
    ir = np.zeros((2, 2, CFG.hrtf_len + 320), np.float64)
    pulse = np.exp(-np.arange(9.0) / 3.0)
    ir[0, :, tof : tof + 9] = pulse
    ir[1, :, tof + 8 : tof + 17] = pulse
    path = tmp_path / "tof.sofa"
    _write_sofa(path, ir, [0.0, 180.0], [0.0, 0.0])
    with pytest.warns(UserWarning, match="time-of-flight"):
        loaded = load("load_sofa", path, mapping="nearest")
    onset = int(np.argmax(np.abs(loaded.hrirs[int(tkemar.pick_hrtf(0.0, 0.0)), 0]) > 1e-6))
    onset180 = int(np.argmax(np.abs(loaded.hrirs[int(tkemar.pick_hrtf(0.0, 180.0)), 0]) > 1e-6))
    assert onset < 8 and onset180 - onset == 8


def test_sofa_validates_malformed_files(tmp_path):
    refused("load_sofa", tmp_path / "nonexistent.sofa", ValueError, "unknown SOFA mapping",
            mapping="interp")
    ir = np.zeros((3, 2, 64), np.float32)
    path = tmp_path / "rows.sofa"
    _write_sofa(path, ir, [0.0, 90.0, 180.0], [0.0] * 3)
    with h5py.File(path, "r+") as f:
        pos = np.asarray(f["SourcePosition"])[:2]
        del f["SourcePosition"]
        f.create_dataset("SourcePosition", data=pos).attrs["Type"] = np.bytes_("spherical")
    refused("load_sofa", path, ValueError, "SourcePosition rows")
    path2 = tmp_path / "empty.sofa"
    _write_sofa(path2, np.zeros((0, 2, 64), np.float32), [], [])
    refused("load_sofa", path2, ValueError, "no measurements")
    path3 = tmp_path / "nosr.sofa"
    _write_sofa(path3, ir, [0.0, 90.0, 180.0], [0.0] * 3)
    with h5py.File(path3, "r+") as f:
        del f["Data.SamplingRate"]
    refused("load_sofa", path3, ValueError, re.escape("Data.SamplingRate"))
    path4 = tmp_path / "baddelay.sofa"
    _write_sofa(path4, ir, [0.0, 90.0, 180.0], [0.0] * 3, delay=[[1.0, 2.0], [3.0, 4.0]])
    refused("load_sofa", path4, ValueError, re.escape("Data.Delay"))


def test_sofa_auto_mapping_dense_stays_nearest(tdb, tmp_path):
    path = tmp_path / "dense.sofa"
    _write_sofa(path, tdb.hrirs[:, :, : CFG.hrtf_len], *_grid())
    loaded = load("load_sofa", path)
    assert loaded.source.endswith(":nearest")
    np.testing.assert_array_equal(loaded.hrirs, tdb.hrirs)


def test_sofa_empty_and_malformed_position_sets(tmp_path):
    cases = (("empty.sofa", np.zeros((0, 2, 8)), np.zeros((0, 3)), "spherical", "no measurements"),
             ("badpos.sofa", np.zeros((2, 2, 8)), np.zeros((2,)), "spherical",
              "SourcePosition must be"),
             ("cart.sofa", np.zeros((2, 2, 8)), np.zeros((2, 3)), "cartesian",
              "unsupported SourcePosition type"))
    for name, ir, pos, kind, match in cases:
        path = tmp_path / name
        with h5py.File(path, "w") as f:
            f.create_dataset("Data.IR", data=ir)
            f.create_dataset("Data.SamplingRate", data=np.array([44100.0]))
            f.create_dataset("SourcePosition", data=pos).attrs["Type"] = np.bytes_(kind)
        refused("load_sofa", path, ValueError, match)


def test_sofa_onset_delay_silent_ir_is_zero():
    assert tsofa._onset_delay(np.zeros((2, 64))) == 0
    ir = np.zeros((2, 64))
    ir[1, 10] = 1.0
    assert tsofa._onset_delay(ir) == jsofa._onset_delay(ir) == 10
    rng = np.random.default_rng(0)
    pair = rng.standard_normal((2, 40))
    for k in (-5, 0, 3):
        np.testing.assert_array_equal(tsofa._shift(pair, k), jsofa._shift(pair, k))


def test_sofa_is_imported_lazily():
    """Importing the port's loaders pulls in no h5py; loading a file does."""
    import subprocess
    import sys

    code = ("import sys, jefferson_tpu_torch, jefferson_tpu_torch.hrtf.sofa, "
            "jefferson_tpu_torch.cli.main; print('h5py' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
