"""The batched one-hot fused step: the plain twin of the CUDA kernel against
the JAX package's Pallas kernel (interpret mode on CPU) and its XLA chain,
the wrapper's dispatch, and the kernel build.

Tolerance: 5e-7 max-abs on the (S*nb, 256) outputs, the JAX package's own
fused-vs-unfused gate (tests/test_batch_parallel.py:834); the overlap-save
histories are slices of the same stream and must be bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jefferson_tpu.engine import batch as jbatch
from jefferson_tpu.engine import plan as jplan
from jefferson_tpu.engine import renderer as jrenderer
from jefferson_tpu.pallas import fused_step as jfs
from jefferson_tpu.trajectory.trajectory import CircularOrbit
from jefferson_tpu_torch.convert import spectra_from_numpy
from jefferson_tpu_torch.engine import batch as tbatch
from jefferson_tpu_torch.kernels import build
from jefferson_tpu_torch.kernels import fused_step as tfs

torch.set_num_threads(1)

TOL = 5e-7


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _chunk(config, s=4, nb=16, radius_step=0.0, xf_every=0, seed=7):
    """One chunk's operands (NumPy), as the bench and the renderer plan it."""
    rng = np.random.default_rng(seed)
    plans = [
        jplan.make_plan(CircularOrbit(period_s=0.4 + 0.01 * i, ele=5, r=1.0 + i * radius_step)
                        .sample(nb, config), config)
        for i in range(s)
    ]
    st = lambda a: np.stack([getattr(p, a) for p in plans])
    c = dict(
        plans=plans,
        feds=(rng.standard_normal((s, nb * config.frames_per_buffer)) * 0.2).astype(np.float32),
        hists=(rng.standard_normal((s, config.history_len)) * 0.2).astype(np.float32),
        xfade=st("xfade").copy(),
        w_last=np.stack([p.w_new[-1] for p in plans]),
        **{a: st(a) for a in ("idx_new", "w_new", "idx_old", "w_old", "u_hi", "u_lo", "inv_frac")},
    )
    if xf_every:
        c["xfade"][:, ::xf_every] = False  # mixed crossfade and steady rows
    c["uniq"], c["ridx"], c["rlast"], c["u_pad"] = jplan.compact_filter_ids(
        c["idx_old"], np.stack([p.idx_new[-1] for p in plans]))
    c["dist"] = jrenderer.dedup_distance(*(np.concatenate([getattr(p, a) for p in plans])
                                          for a in ("u_hi", "u_lo", "inv_frac")))
    return c


def _jax_spectra(db):
    return (jnp.asarray(np.real(db.spectra).astype(np.float32)),
            jnp.asarray(np.imag(db.spectra).astype(np.float32)))


def _dist_args(c, compact, s, nb, put):
    if compact:
        d = c["dist"]
        return (put(d[0]), put(d[1]), put(d[2])), put(d[3].reshape(s, nb)), d[4]
    return tuple(put(c[a]) for a in ("u_hi", "u_lo", "inv_frac")), None, None


@pytest.mark.parametrize("compact,xf_every", [(True, 0), (True, 3), (False, 0), (False, 2)])
def test_twin_matches_pallas_onehot_and_xla_chain(db, config, compact, xf_every):
    s, nb = 4, 16
    c = _chunk(config, s, nb, radius_step=0.0 if compact else 0.05, xf_every=xf_every)
    assert c["dist"] is not None or not compact
    jd, jsel, nd = _dist_args(c, compact, s, nb, jnp.asarray)
    tb = jrenderer.pick_fused_tile(s * nb, nb)
    pallas = jax.jit(jbatch.batched_chunk_fn_fused(config, num_blocks=nb, tb=tb, onehot=True, n_dist=nd))
    y_p, h_p = pallas(
        _jax_spectra(db), jnp.asarray(c["hists"]), jnp.asarray(c["feds"]), jnp.asarray(c["uniq"]),
        jnp.asarray(c["ridx"]), jnp.asarray(c["w_old"]), jnp.asarray(c["rlast"]),
        jnp.asarray(c["w_last"]), jnp.asarray(c["xfade"]), *jd,
        **({} if jsel is None else {"dsel": jsel}),
    )
    chain = jax.jit(jbatch.batched_chunk_fn(config, num_blocks=nb, with_xfade=True))
    y_x, h_x = chain(_jax_spectra(db), *(jnp.asarray(c[a]) for a in (
        "hists", "feds", "idx_new", "w_new", "idx_old", "w_old", "xfade", "u_hi", "u_lo", "inv_frac")))

    td, tsel, tnd = _dist_args(c, compact, s, nb, _t)
    before = dict(tfs.launches)
    y, h = tbatch.batched_chunk_fn_fused(config, nb, tb, onehot=True, n_dist=tnd)(
        spectra_from_numpy(db.spectra, "cpu"), _t(c["hists"]), _t(c["feds"]), _t(c["uniq"]),
        _t(c["ridx"]), _t(c["w_old"]), _t(c["rlast"]), _t(c["w_last"]), _t(c["xfade"]), *td,
        dsel=tsel,
    )
    assert tfs.launches == before  # CPU operands run the twin, never the kernel
    assert y.shape == (s, nb, config.frames_per_buffer, 2)
    assert np.abs(y.numpy() - np.asarray(y_p)).max() <= TOL
    assert np.abs(y.numpy() - np.asarray(y_x)).max() <= TOL
    np.testing.assert_array_equal(h.numpy(), np.asarray(h_p))
    np.testing.assert_array_equal(h.numpy(), np.asarray(h_x))


def _step_operands(db, config, c, s, nb, compact):
    td, tsel, tnd = _dist_args(c, compact, s, nb, _t)
    args, kw, _ = tbatch.onehot_step_operands(
        config, nb, tnd, spectra_from_numpy(db.spectra, "cpu"), _t(c["hists"]), _t(c["feds"]),
        _t(c["uniq"]), _t(c["ridx"]), _t(c["w_old"]), _t(c["rlast"]), _t(c["w_last"]),
        _t(c["xfade"]), *td, dsel=tsel)
    return list(args), kw


@pytest.mark.parametrize("compact", [True, False])
def test_ids_and_selectors_outside_the_table_match_the_tpu_kernel(db, config, compact):
    """An id outside the compact table matches no one-hot column, and a
    selector outside 1..n_dist-1 takes triple 0: the twin gives the Pallas
    kernel's answer for both."""
    s, nb = 2, 8
    c = _chunk(config, s, nb, radius_step=0.0 if compact else 0.05, seed=3)
    args, kw = _step_operands(db, config, c, s, nb, compact)
    u = args[4].shape[0]
    ridx, rlast = args[5].clone(), args[7].clone()
    ridx[1, 2], ridx[5, 0], ridx[9, 3], rlast[1, 1] = u, -1, u + 40, -7
    args[5], args[7] = ridx, rlast
    if compact:
        dsel = kw["dsel"].clone()
        dsel[3, 0], dsel[12, 0] = 7, -2
        kw["dsel"] = dsel
    got = tfs.fused_step_onehot_xfade(*args, **kw)
    j = [jnp.asarray(a.numpy()) for a in args]
    want = jfs.fused_step_onehot_xfade(
        *j, nb=nb, pad_len=config.pad_len, bins=config.num_bins, fpb=config.frames_per_buffer,
        tb=s * nb, interpret=True, n_dist=kw["n_dist"],
        dsel=None if kw["dsel"] is None else jnp.asarray(kw["dsel"].numpy()),
    )
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL


def test_wrapper_checks_operands(db, config):
    s, nb = 2, 8
    c = _chunk(config, s, nb, seed=5)
    args, kw = _step_operands(db, config, c, s, nb, compact=True)
    with pytest.raises(ValueError, match="history"):
        tfs.fused_step_onehot_xfade(args[0][:, 1:], *args[1:], **kw)
    with pytest.raises(ValueError, match="go together"):
        tfs.fused_step_onehot_xfade(*args, **{**kw, "dsel": None})
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="one device"):
        tfs.fused_step_onehot_xfade(meta[0], *args[1:], **kw)
    with pytest.raises(ValueError, match="no kernel for device"):
        tfs.fused_step_onehot_xfade(*meta, **{**kw, "dsel": kw["dsel"].to("meta")})


def test_build_keys_the_library_by_source_and_raises_without_nvcc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text("extern \"C\" int f() { return 0; }\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    first = build.library_path("k")
    assert first.parent == tmp_path / "out" and first.name.startswith("k-")
    (tmp_path / "k.cu").write_text("extern \"C\" int f() { return 1; }\n")
    assert build.library_path("k") != first
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("k")
    assert not (tmp_path / "out").exists() or not any((tmp_path / "out").iterdir())


def test_the_shipped_kernel_source_is_found_and_keyed():
    path = build.library_path("fused_step_onehot")
    assert (build.CSRC / "fused_step_onehot.cu").is_file()
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
    assert "--use_fast_math" not in build.NVCC_FLAGS
