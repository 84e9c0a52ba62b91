"""The single-stream fused steps (kernel rows 3, 4 and 5): each plain twin
against the JAX package's Pallas kernel in interpret mode, the no-crossfade
contract, the TPU kernels' answer for ids outside the table, the wrappers'
operand checks, and the build's source hashing.

Tolerance: 5e-7 max-abs on the (B, 256) outputs, the JAX package's own
fused-vs-unfused gate (tests/test_batch_parallel.py:834).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jefferson_tpu.pallas import fused_step as jfs
from jefferson_tpu_torch import bench
from jefferson_tpu_torch.convert import database_from_numpy
from jefferson_tpu_torch.kernels import build
from jefferson_tpu_torch.kernels import fused_step as tfs

torch.set_num_threads(1)

TOL = 5e-7


@pytest.fixture(scope="module")
def tdb(db):
    """The port's database, carried across from the JAX fixture."""
    return database_from_numpy(db.spectra, db.hrirs, dataclasses.asdict(db.config))


def _j(a):
    return None if a is None else jnp.asarray(a.numpy())


def _pallas(fn, args, kw, tb):
    """The same step through the JAX package's Pallas kernel (interpreted
    off the TPU)."""
    jkw = {**kw, "dsel": _j(kw.get("dsel")), "tb": tb}
    return np.asarray(getattr(jfs, fn.__name__)(*map(_j, args), **jkw))


def _run(fn, args, kw):
    before = dict(tfs.launches)
    got = fn(*args, **kw)
    assert tfs.launches == before  # CPU operands run the twin, never a kernel
    return got.numpy()


@pytest.mark.parametrize("radius_step,xf_every", [(0.0, 0), (0.0, 3), (0.05, 0), (0.05, 2)])
def test_stream_onehot_twin_matches_pallas(tdb, radius_step, xf_every):
    fn, args, kw = bench.stream_step(tdb, "onehot", 64, "cpu", radius_step=radius_step,
                                     xf_every=xf_every, seed=1)
    assert ("n_dist" in kw) == (radius_step == 0.0)
    got = _run(fn, args, kw)
    assert got.shape == (64, 256)
    assert np.abs(got - _pallas(fn, args, kw, tb=16)).max() <= TOL


@pytest.mark.parametrize("trajectory", ["mover", "orbit"])
def test_stream_onehot_grouped_twin_matches_pallas(tdb, trajectory):
    fn, args, kw = bench.stream_step(tdb, "grouped", 64, "cpu", trajectory=trajectory,
                                     tb=16, group_tiles=2, seed=2)
    assert ("n_dist" in kw) == (trajectory == "orbit")
    assert args[4].shape[0] == 2 * kw["u_pad"]  # two groups of 32 blocks
    got = _run(fn, args, kw)
    assert np.abs(got - _pallas(fn, args, kw, tb=16)).max() <= TOL


@pytest.mark.parametrize("form", ["gather", "gather_noxf"])
@pytest.mark.parametrize("radius_step", [0.0, 0.05])
def test_stream_gather_twin_matches_pallas(tdb, form, radius_step):
    fn, args, kw = bench.stream_step(tdb, form, 32, "cpu", radius_step=radius_step, seed=3)
    got = _run(fn, args, kw)
    assert got.shape == (32, 256)
    assert np.abs(got - _pallas(fn, args, kw, tb=8)).max() <= TOL


def test_stream_gather_forms_bit_equal_without_crossfade(tdb):
    """On a crossfade-free plan the no-crossfade form gives the crossfade
    form's bits (out = y_old*0 + y_new*1), the JAX package's contract
    (tests/test_noxfade.py:84-111)."""
    fn, args, kw = bench.stream_step(tdb, "gather", 32, "cpu", trajectory="hold", seed=4)
    _, args_n, kw_n = bench.stream_step(tdb, "gather_noxf", 32, "cpu", trajectory="hold", seed=4)
    assert not args[-1].any()  # no crossfade anywhere
    with_xf = fn(*args, **kw)
    without = fn(*args_n, **kw_n)
    assert torch.equal(with_xf, without)
    assert np.abs(without.numpy() - _pallas(fn, args_n, kw_n, tb=8)).max() <= TOL


@pytest.mark.parametrize("form", ["onehot", "grouped"])
def test_ids_outside_the_table_match_the_tpu_kernel(tdb, form):
    """An id outside the (group's) table matches no one-hot column and a
    selector outside 1..n_dist-1 takes triple 0: the twins give the Pallas
    kernel's answer for both."""
    fn, args, kw = bench.stream_step(tdb, form, 64, "cpu", trajectory="orbit", tb=16,
                                     group_tiles=2, seed=5)
    args = list(args)
    u = kw.get("u_pad", args[4].shape[0])
    ridx, bnd = args[5].clone(), args[7].clone()
    ridx[1, 2], ridx[17, 0], ridx[40, 3], bnd[-1, 1] = u, -1, u + 40, -7
    if form == "grouped":
        bnd[0, 2] = u + 1
    args[5], args[7] = ridx, bnd
    dsel = kw["dsel"].clone()
    dsel[3, 0], dsel[12, 0] = 7, -2
    kw = {**kw, "dsel": dsel}
    got = _run(fn, args, kw)
    assert np.abs(got - _pallas(fn, args, kw, tb=16)).max() <= TOL


def test_wrappers_check_operands(tdb):
    fn, args, kw = bench.stream_step(tdb, "onehot", 16, "cpu")
    with pytest.raises(ValueError, match="history"):
        fn(args[0][1:], *args[1:], **kw)
    with pytest.raises(ValueError, match="go together"):
        fn(*args, **{**kw, "dsel": None})
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="one device"):
        fn(meta[0], *args[1:], **kw)
    with pytest.raises(ValueError, match="no kernel for device"):
        fn(*meta, **{**kw, "dsel": kw["dsel"].to("meta")})

    fn, args, kw = bench.stream_step(tdb, "grouped", 32, "cpu", tb=8, group_tiles=2)
    with pytest.raises(ValueError, match="do not split"):
        fn(*args, **{**kw, "group_tiles": 3})
    with pytest.raises(ValueError, match="groups of"):
        fn(*args, **{**kw, "u_pad": kw["u_pad"] * 2})

    fn, args, kw = bench.stream_step(tdb, "gather", 16, "cpu")
    with pytest.raises(ValueError, match="needs g_last and xf"):
        fn(*args[:5], None, args[6], **kw)
    _, noxf, kw_n = bench.stream_step(tdb, "gather_noxf", 16, "cpu")
    assert noxf[5] is None and noxf[6] is None  # the no-crossfade form takes neither


def test_stream_step_builder_rejects_unknown_forms(tdb):
    with pytest.raises(ValueError, match="not in"):
        bench.stream_step(tdb, "apply", 16, "cpu")


def test_build_hashes_the_headers_a_source_includes(tmp_path, monkeypatch):
    """Editing a shared header rebuilds every library that includes it."""
    (tmp_path / "shared.cuh").write_text("#pragma once\nconstexpr int K = 1;\n")
    (tmp_path / "deep.cuh").write_text('#include "shared.cuh"\n')
    (tmp_path / "a.cu").write_text('#include "deep.cuh"\n#include <cuda_runtime.h>\n')
    (tmp_path / "b.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "c.cu").write_text("int c;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert [p.name for p in build.sources("a")] == ["a.cu", "deep.cuh", "shared.cuh"]
    before = {n: build.library_path(n) for n in "abc"}
    (tmp_path / "shared.cuh").write_text("#pragma once\nconstexpr int K = 2;\n")
    after = {n: build.library_path(n) for n in "abc"}
    assert after["a"] != before["a"] and after["b"] != before["b"]
    assert after["c"] == before["c"]


def test_the_shipped_sources_share_the_forward_header():
    headers = {
        "fused_step_onehot": ["fused_forward.cuh", "cp_async.cuh", "entry.cuh"],
        "fused_step_gather": ["fused_forward.cuh", "cp_async.cuh", "entry.cuh"],
        "assoc_probe": ["entry.cuh"],
        "dma_blend": ["cp_async.cuh", "entry.cuh"],
    }
    assert sorted(headers) == sorted(p.stem for p in build.CSRC.glob("*.cu"))
    for name, want in headers.items():
        assert [p.name for p in build.sources(name)] == [f"{name}.cu", *want]


def test_launch_counts_reset():
    tfs.launches["fused_step_stream_xfade"] += 3
    tfs.reset_launches()
    assert set(tfs.launches.values()) == {0} and len(tfs.launches) == 15
