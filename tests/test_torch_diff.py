"""The port's differentiable renderer (``jefferson_tpu_torch.diff.render``)
against the JAX package's, on the CPU.

The JAX 12-block localization runs once per module with every jitted
function of ``jefferson_tpu/diff/render.py`` logged (``_JitLog``), so the
port's grid stage, one Adam step and a 20-step descent are held to the JAX
function's own intermediates on the same inputs.  The three localization
cases of ``tests/test_diff.py`` run through the port under the JAX gates.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jefferson_tpu.diff import render as jrender
from jefferson_tpu.hrtf.kemar import pick_hrtf
from jefferson_tpu_torch.convert import database_from_numpy
from jefferson_tpu_torch.diff import render as trender
from jefferson_tpu_torch.diff.render import DifferentiableRenderer, smooth, smooth_coeffs

torch.set_num_threads(1)

FWD_REL = 1e-6     # forward planes, of their peak: fp32 matmul sums in another order
SPECTRA_TOL = 1e-6  # render_spectra, absolute, on a 0.3-peak signal
GRAD_REL = 1e-4    # position gradients, per column of its max |g|
GRID_REL = 1e-5    # grid losses, of the chunk's largest
# positions after one Adam step: 1e-6, or one float32 spacing of the
# position where that is larger (measured: one spacing, 7.6e-6, at 90
# degrees; 7.2e-7 in the radius): the step moves each coordinate by
# lr·g/(|g| + ε), and two roundings of it may land on neighbouring floats
STEP_TOL = 1e-6
# positions after 20 Adam steps at width 4: measured 9.5e-6 (degrees, about
# one float32 spacing at 90; the radius 9.5e-7 m): optax and
# torch.optim.Adam round m̂/(√v̂ + ε) in other orders, and each step moves a
# coordinate by about lr whatever |g| is, so roundings add up step by step
DESCENT_TOL = 1e-4
LOC_DEG, LOC_M = 0.5, 0.01  # the 12-block localize against the JAX one


@pytest.fixture(scope="module")
def tdb(db):
    return database_from_numpy(db.spectra, db.hrirs, dataclasses.asdict(db.config))


@pytest.fixture(scope="module")
def tren(tdb):
    return DifferentiableRenderer(tdb, device="cpu")


def _probe(seed: int, n: int = 9000) -> np.ndarray:
    """tests/test_diff.py's band-limited probe signal, 0.3 peak."""
    rng = np.random.default_rng(seed)
    sig = np.convolve(rng.standard_normal(n), np.hanning(16), mode="same")
    return (0.3 * sig / np.abs(sig).max()).astype(np.float32)


class _JitLog:
    """Stands in for ``jax`` inside the JAX module: each jitted function's
    calls are logged as (args, result), one list per function in the order
    the functions are made (localize: the grid chunk, the fullband loss,
    then one Adam step per (width, rate): 64, 16, 4, 1 at lr, 4, 1 at lr/2)."""

    def __init__(self):
        self.fns = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, f):
        jitted, calls = jax.jit(f), []
        self.fns.append(calls)

        def call(*args):
            out = jitted(*args)
            calls.append((args, out))
            return out

        return call


@pytest.fixture(scope="module")
def case12(db, config, tren):
    """tests/test_diff.py's 12-block case, (62, 18, 1.3) from (40, 0, 1),
    400 steps at lr 0.1: the JAX run logged, and the port's run."""
    sig, b = _probe(42), 12
    jren = jrender.DifferentiableRenderer(db, config)
    true_pos = np.tile([62.0, 18.0, 1.3], (b, 1)).astype(np.float32)
    target = np.asarray(jren.render(sig, true_pos))
    init = np.tile([40.0, 0.0, 1.0], (b, 1)).astype(np.float32)
    log = _JitLog()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrender, "jax", log)
        jfit, jhist = jren.localize(sig, target, init, steps=400, lr=0.1)
    tfit, thist = tren.localize(sig, target, init, steps=400, lr=0.1)
    return dict(sig=sig, target=target, init=init, log=log.fns, jfit=jfit, jhist=jhist,
                tfit=tfit, thist=thist, timings=dict(tren.timings))


def _angles():
    """Seeded azimuths and elevations, plus every exact case: grid points
    (every 10 and 5 degrees and each ring's own points), the 0/360 wrap,
    negative azimuths, elevations at and beyond -40 and 90."""
    rng = np.random.default_rng(0)
    azi = [rng.uniform(-400.0, 800.0, 1000)]
    ele = [rng.uniform(-60.0, 110.0, 1000)]
    grid_a, grid_e = np.meshgrid(np.arange(-360.0, 721.0, 5.0), np.arange(-50.0, 101.0, 10.0))
    azi.append(grid_a.ravel())
    ele.append(grid_e.ravel())
    from jefferson_tpu.hrtf.kemar import AZIMUTH_GRIDS, ELEVATIONS

    for e, ring in zip(ELEVATIONS, AZIMUTH_GRIDS):
        azi.append(ring)
        ele.append(np.full(len(ring), float(e)))
    edge_a = [359.9999, 360.0, 720.0, -1e-6, -0.0, 0.0, -5.0, -360.0, 359.0, 0.1]
    for e in (-40.0, -41.0, -1000.0, 90.0, 90.5, 1000.0, 0.0, 89.99):
        azi.append(np.asarray(edge_a))
        ele.append(np.full(len(edge_a), e))
    return (np.concatenate(azi).astype(np.float32), np.concatenate(ele).astype(np.float32))


def test_smooth_coeffs_bit_equal_to_jax():
    azi, ele = _angles()
    ji, jw = jrender.smooth_coeffs(jnp.asarray(azi), jnp.asarray(ele))
    ti, tw = smooth_coeffs(torch.from_numpy(azi), torch.from_numpy(ele))
    assert ti.dtype == torch.int64 and tw.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_smooth_weights_sum_to_one_and_collapse_on_grid_points():
    """tests/test_diff.py's three smooth-weight checks, through the port."""
    rng = np.random.default_rng(0)
    idx, w = smooth_coeffs(torch.from_numpy(rng.uniform(0, 360, 200).astype(np.float32)),
                           torch.from_numpy(rng.uniform(-40, 90, 200).astype(np.float32)))
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-5)
    assert ((idx >= 0) & (idx < 710)).all()
    idx, w = smooth_coeffs(torch.tensor([90.0]), torch.tensor([0.0]))
    assert int(idx[0, int(torch.argmax(w[0]))]) == pick_hrtf(0, 90) and float(w.max()) > 0.999
    i1, _ = smooth_coeffs(torch.tensor([359.9]), torch.tensor([0.0]))
    i2, _ = smooth_coeffs(torch.tensor([0.1]), torch.tensor([0.0]))
    assert set(i1[0, :2].tolist()) == {pick_hrtf(0, 355), pick_hrtf(0, 0)}
    assert set(i2[0, :2].tolist()) == {pick_hrtf(0, 0), pick_hrtf(0, 5)}


def test_clip_gradient_at_the_bounds_is_jaxs_half():
    x = np.array([0.0, 1.0, 0.5, -1.0, 2.0], np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.clip(v, 0.0, 1.0).sum())(jnp.asarray(x)))
    np.testing.assert_array_equal(want, [0.5, 0.5, 1.0, 0.0, 0.0])
    t = torch.from_numpy(x).requires_grad_(True)
    trender.clip(t, 0.0, 1.0).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), want)
    c = torch.from_numpy(x).requires_grad_(True)
    torch.clamp(c, 0.0, 1.0).sum().backward()
    assert c.grad[:2].tolist() == [1.0, 1.0]  # what the port's clip must not be


@pytest.mark.parametrize("azi,ele", [(40.0, 0.0), (90.0, 90.0), (10.0, -40.0), (45.0, 10.0),
                                     (0.0, 20.0), (33.0, 17.0)])
def test_weight_gradients_on_the_bounds_are_jaxs(azi, ele):
    """The candidates' bounds: fe = 0 every 10 degrees, fa = 0 on the
    5-degree rings, the elevation clip at -40 and 90.  A port written with
    torch.clamp fails every case but (33, 17), which lies on no bound."""
    coef = np.arange(1.0, 5.0, dtype=np.float32)
    a, e = np.float32(azi), np.float32(ele)
    jg = jax.grad(lambda p: jnp.sum(jrender.smooth_coeffs(p[0:1], p[1:2])[1] * coef),
                  )(jnp.asarray([a, e]))
    p = torch.tensor([a, e], requires_grad=True)
    torch.sum(smooth_coeffs(p[0:1], p[1:2])[1] * torch.from_numpy(coef)).backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("nb", [8, 64])
def test_forward_and_render_spectra_match_jax(db, config, tren, nb):
    jren = jrender.DifferentiableRenderer(db, config)
    sig = _probe(1)
    jx, tx = jren._forward(sig, nb), tren._forward(sig, nb)
    for j, t in zip(jx, tx):
        assert t.shape == (nb, config.num_bins)
        # measured 3.1e-7 of the peak (5.7e-6 absolute at a peak of 18.7):
        # the planes reach tens, so 1e-6 absolute would ask for fp32 sums
        # of 128 terms in the same order
        assert np.abs(t.numpy() - np.asarray(j)).max() <= FWD_REL * np.abs(np.asarray(j)).max()
    rng = np.random.default_rng(nb)
    pos = np.stack([rng.uniform(0, 360, nb), rng.uniform(-40, 90, nb), rng.uniform(0.3, 4, nb)],
                   -1).astype(np.float32)
    pos[:4] = [[40.0, 0.0, 1.0], [90.0, 90.0, 1.5], [10.0, -40.0, 0.5], [0.0, 20.0, 4.0]]
    want = np.asarray(jren.render_spectra(*jx, jnp.asarray(pos)))
    got = tren.render_spectra(*tx, torch.from_numpy(pos))
    assert got.shape == (nb, config.frames_per_buffer, 2)
    assert np.abs(got.numpy() - want).max() <= SPECTRA_TOL
    out = tren.render(sig, pos)
    assert out.shape == (nb * config.frames_per_buffer, 2)
    np.testing.assert_array_equal(out.numpy(), got.reshape(-1, 2).numpy())


def test_render_gradients_match_jax(db, config, tren, castanets):
    """tests/test_diff.py's gradient loss, sum(render_spectra(...)**2), at
    its (45, 10, 1) and at positions on the clip bounds."""
    jren = jrender.DifferentiableRenderer(db, config)
    pos = np.array([[45.0, 10.0, 1.0], [45.0, 10.0, 1.0], [40.0, 0.0, 1.0], [90.0, 90.0, 1.2],
                    [10.0, -40.0, 0.7], [0.0, 20.0, 2.0], [355.0, -20.0, 1.0],
                    [123.0, 37.0, 3.0]], np.float32)
    jx = jren._forward(castanets, 8)
    jg = np.asarray(jax.grad(lambda p: jnp.sum(jren.render_spectra(*jx, p) ** 2))(
        jnp.asarray(pos)))
    tx = tren._forward(castanets, 8)
    p = torch.from_numpy(pos).requires_grad_(True)
    torch.sum(tren.render_spectra(*tx, p) ** 2).backward()
    g = p.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g[:, 0]).max() > 0 and np.abs(g[:, 2]).max() > 0
    for col in range(3):
        assert np.abs(g[:, col] - jg[:, col]).max() <= GRAD_REL * np.abs(jg[:, col]).max(), col


def _jax_smooth(blocks: np.ndarray, width: int) -> np.ndarray:
    """The JAX localize's smoother (jefferson_tpu/diff/render.py:169-183)."""
    b = blocks.shape[0]
    win = jnp.asarray((np.hanning(width) / np.hanning(width).sum()).astype(np.float32))
    t = jnp.transpose(jnp.asarray(blocks), (2, 0, 1)).reshape(2, 1, -1)
    y = jax.lax.conv_general_dilated(t, win[None, None, :], (1,), "SAME",
                                     dimension_numbers=("NCH", "OIH", "NCH"))
    return np.asarray(jnp.transpose(y.reshape(2, b, -1), (1, 2, 0)))


@pytest.mark.parametrize("width", [64, 16, 4, 1])
def test_smoother_matches_jax(width):
    blocks = np.random.default_rng(width).standard_normal((6, 128, 2)).astype(np.float32)
    want = _jax_smooth(blocks, width) if width > 1 else blocks
    got = smooth(torch.from_numpy(blocks), width).numpy()
    assert np.abs(got - want).max() <= 1e-6
    # an impulse shows the padding and orientation: XLA's SAME puts
    # (width-1)//2 zeros first, so the window's tap (width-1)//2 lands on it
    imp = np.zeros((6, 128, 2), np.float32)
    imp[2, 17, 1] = 1.0
    want = _jax_smooth(imp, width) if width > 1 else imp
    np.testing.assert_array_equal(smooth(torch.from_numpy(imp), width).numpy(), want)
    # a batch of candidates is each candidate alone
    batch = np.stack([blocks, 2 * blocks])
    np.testing.assert_array_equal(smooth(torch.from_numpy(batch), width)[1].numpy(),
                                  smooth(torch.from_numpy(2 * blocks), width).numpy())


def _fit(tren, case):
    return trender._Fit(tren, case["sig"], case["target"], case["init"], True)


def test_grid_stage_matches_jax(case12, tren):
    """Every coarse-grid chunk (36 x 14 x 6 candidates, 12 chunks of 256)
    against the JAX chunk's per-block losses, and the same winner."""
    calls = case12["log"][0][:12]
    fit = _fit(tren, case12)
    got, want = [], []
    for (cands,), out in calls:
        got.append(fit.grid(np.asarray(cands)))
        want.append(np.asarray(out))
        assert np.abs(got[-1] - want[-1]).max() <= GRID_REL * np.abs(want[-1]).max()
    got, want = np.concatenate(got), np.concatenate(want)
    assert int(np.argmin(got.mean(1))) == int(np.argmin(want.mean(1)))
    # the JAX descent starts from that winner at every block
    cands = np.concatenate([np.asarray(c[0][0]) for c in calls])
    start = np.asarray(case12["log"][2][0][0][0])
    np.testing.assert_array_equal(start, np.tile(cands[int(np.argmin(got.mean(1)))], (12, 1)))


def test_one_adam_step_matches_jax(case12, tren):
    (pos, _), (new_pos, _, loss) = case12["log"][2][0]
    fit = _fit(tren, case12)
    got = fit.descend(torch.tensor(np.asarray(pos)), [64], 1, 0.1)
    assert abs(fit.history[0] - float(loss)) <= 1e-6 * float(loss)
    want = np.asarray(new_pos)
    assert (np.abs(got.numpy() - want) <= np.maximum(STEP_TOL, np.spacing(np.abs(want)))).all()


def test_twenty_step_descent_at_width_4_matches_jax(case12, tren):
    calls = case12["log"][4]
    pos, want = np.asarray(calls[0][0][0]), np.asarray(calls[19][1][0])
    fit = _fit(tren, case12)
    got = fit.descend(torch.tensor(pos), [4], 20, 0.1).numpy()
    assert np.abs(got - want).max() <= DESCENT_TOL
    np.testing.assert_allclose(fit.history, [float(c[1][2]) for c in calls[:20]], rtol=1e-4)


def test_localization_recovers_position(case12):
    """tests/test_diff.py's gates, through the port."""
    fitted, hist = case12["tfit"], case12["thist"]
    assert hist[-1] < hist[0] * 0.25, f"loss did not drop: {hist[0]} -> {hist[-1]}"
    assert np.abs(fitted[:, 0] - 62.0).mean() < 5.0
    assert np.abs(fitted[:, 1] - 18.0).mean() < 5.0
    assert np.abs(fitted[:, 2] - 1.3).mean() < 0.1


def test_localization_matches_jax(case12):
    """The port's 12-block fit against the JAX one: the same stages
    (history length), positions within LOC_DEG and LOC_M."""
    tf, jf = case12["tfit"], case12["jfit"]
    assert len(case12["thist"]) == len(case12["jhist"]) == 1 + 400 + 100 + 1
    assert np.abs(tf[:, :2] - jf[:, :2]).max() < LOC_DEG
    assert np.abs(tf[:, 2] - jf[:, 2]).max() < LOC_M
    np.testing.assert_allclose(case12["thist"][0], case12["jhist"][0], rtol=1e-5)
    t = case12["timings"]
    assert (t["grid_candidates"], t["descent_steps"], t["polish_steps"]) == (3024, 400, 100)
    assert t["fine_grid_candidates"] == 120 * 44


def test_localization_moving_source(tren):
    """tests/test_diff.py's two-segment case, through the port."""
    sig, b = _probe(3), 12
    true_pos = np.concatenate([np.tile([80.0, 0.0, 1.0], (b // 2, 1)),
                               np.tile([290.0, 0.0, 1.0], (b // 2, 1))]).astype(np.float32)
    target = tren.render(sig, true_pos)
    init = np.tile([0.0, 0.0, 1.0], (b, 1)).astype(np.float32)
    fitted, hist = tren.localize(sig, target, init, steps=200, lr=0.1, segment_blocks=b // 2)
    assert np.abs(fitted[: b // 2, 0] - 80.0).mean() < 10.0
    d2 = np.minimum(np.abs(fitted[b // 2:, 0] - 290.0), 360 - np.abs(fitted[b // 2:, 0] - 290.0))
    assert d2.mean() < 10.0


def test_localization_fixed_radius_keeps_caller_radii(tren):
    """tests/test_diff.py's optimize_r=False case: the caller's per-block
    radii come back bit for bit (the masked gradient is 0, and so is
    torch.optim.Adam's update)."""
    sig, b = _probe(7), 12
    radii = np.linspace(0.8, 2.0, b).astype(np.float32)
    true_pos = np.stack([np.full(b, 75.0), np.full(b, 10.0), radii], axis=-1).astype(np.float32)
    target = tren.render(sig, true_pos)
    init = np.stack([np.full(b, 10.0), np.zeros(b), radii], axis=-1).astype(np.float32)
    fitted, hist = tren.localize(sig, target, init, steps=200, lr=0.1, optimize_r=False)
    np.testing.assert_array_equal(fitted[:, 2], radii)
    assert np.abs(fitted[:, 0] - 75.0).mean() < 8.0
    assert hist[-1] < hist[0], (hist[0], hist[-1])


def test_localization_rejects_bad_segment_blocks(tren, config):
    sig = np.zeros(2000, np.float32)
    pos = np.tile([0.0, 0.0, 1.0], (4, 1)).astype(np.float32)
    tgt = np.zeros((4 * config.frames_per_buffer, 2), np.float32)
    for bad in (-4, 0):
        with pytest.raises(ValueError, match="segment_blocks"):
            tren.localize(sig, tgt, pos, steps=1, segment_blocks=bad)
