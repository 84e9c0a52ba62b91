"""The port's DFT and filter ops against the JAX package's, on CPU.

The NumPy basis builders and ``distance_phase_split`` are copies and must be
bit-equal to the originals; the torch ops must match the jnp ops to 5e-7
(fp32 matmuls summed in another order).  The forward DFT planes of a
0.2-std signal peak near 17, and a K-deep fp32 dot there is a few ulps of
the peak from the float64 DFT on either side, so those are held to 1e-6 of
their peak instead (FWD_REL).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jefferson_tpu.ops import fft as jfft
from jefferson_tpu.ops import filters as jfilters
from jefferson_tpu_torch.ops import fft as tfft
from jefferson_tpu_torch.ops import filters as tfilters

torch.set_num_threads(1)

TOL = 5e-7
FWD_REL = 1e-6
N, SUB, TAIL = 1024, 128, 128
BINS = N // 2 + 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _max_diff(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))))


def _fwd_close(got, want):
    """Forward planes agree to FWD_REL of their peak."""
    return _max_diff(got, want) <= FWD_REL * float(np.max(np.abs(np.asarray(want))))


@pytest.mark.parametrize("name,args", [
    ("_dft_matrices", (N,)),
    ("_dft_matrices", (256,)),
    ("_idft_matrices", (N,)),
    ("_idft_matrices", (255,)),
    ("_subblock_dft_matrices", (N, SUB)),
    ("_sliding_twiddles", (N, SUB)),
    ("_idft_tail_matrices", (N, TAIL)),
])
def test_basis_builders_are_bit_equal(name, args):
    got, want = getattr(tfft, name)(*args), getattr(jfft, name)(*args)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("native", [True, False])
def test_distance_phase_split_is_bit_equal(native, monkeypatch):
    import jefferson_tpu.native as native_mod

    if native and not native_mod.HAVE_NATIVE:
        pytest.skip("the native extension is not built")
    monkeypatch.setattr(native_mod, "HAVE_NATIVE", native)
    rng = np.random.default_rng(3)
    for radii in (rng.uniform(0.01, 2.0, 37).astype(np.float32),
                  rng.uniform(0.01, 2.0, (3, 5)).astype(np.float32)):
        got = tfilters.distance_phase_split(343.0 / 44100.0 * 1000, radii, BINS)
        want = jfilters.distance_phase_split(343.0 / 44100.0 * 1000, radii, BINS)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_rfft_split_matches_jax():
    x = np.random.default_rng(0).standard_normal((6, N)).astype(np.float32) * 0.2
    got = tfft.rfft_split(_t(x), N)
    want = jfft.rfft_split(jnp.asarray(x), N)
    for g, w in zip(got, want):
        assert g.shape == (6, BINS)
        assert _fwd_close(g, w)


def test_rfft_sliding_split_matches_jax_and_direct():
    nb = 9
    stream = np.random.default_rng(1).standard_normal(nb * SUB + N - SUB).astype(np.float32) * 0.2
    got = tfft.rfft_sliding_split(_t(stream), nb, SUB, N)
    want = jfft.rfft_sliding_split(jnp.asarray(stream), nb, SUB, N)
    for g, w in zip(got, want):
        assert g.shape == (nb, BINS)
        assert _fwd_close(g, w)
    windows = np.stack([stream[b * SUB : b * SUB + N] for b in range(nb)])
    direct = tfft.rfft_split(_t(windows), N)
    for g, d in zip(got, direct):
        assert _fwd_close(g, d)  # the sliding and the direct forward agree


def test_rfft_sliding_split_batched_matches_jax():
    s, nb = 3, 5
    streams = np.random.default_rng(2).standard_normal((s, nb * SUB + N - SUB)).astype(np.float32) * 0.2
    got = tfft.rfft_sliding_split_batched(_t(streams), nb, SUB, N)
    want = jfft.rfft_sliding_split_batched(jnp.asarray(streams), nb, SUB, N)
    for g, w in zip(got, want):
        assert g.shape == (s, nb, BINS)
        assert _fwd_close(g, w)
    single = tfft.rfft_sliding_split(_t(streams[1]), nb, SUB, N)
    for g, one in zip(got, single):
        assert _fwd_close(g[1], one)


def test_irfft_tail_split_matches_jax_and_numpy():
    rng = np.random.default_rng(4)
    re = rng.standard_normal((2, 7, BINS)).astype(np.float32)
    im = rng.standard_normal((2, 7, BINS)).astype(np.float32)
    im[..., 0] = im[..., -1] = 0.0  # a real signal's DC and Nyquist bins
    got = tfft.irfft_tail_split(_t(re), _t(im), N, TAIL)
    want = jfft.irfft_tail_split(jnp.asarray(re), jnp.asarray(im), N, TAIL)
    assert got.shape == (2, 7, TAIL)
    assert _max_diff(got, want) <= TOL
    ref = np.fft.irfft(re.astype(np.float64) + 1j * im, N)[..., N - TAIL :]
    assert _max_diff(got, ref) <= 1e-6


def test_cmul_matches_jax():
    a = np.random.default_rng(5).standard_normal((4, 3, 11)).astype(np.float32)
    got = tfilters.cmul(*(_t(x) for x in a))
    want = jfilters.cmul(*(jnp.asarray(x) for x in a))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_distance_factors_split_matches_jax():
    rng = np.random.default_rng(6)
    radii = rng.uniform(0.02, 1.5, 64).astype(np.float32)
    uh, ul, fr = jfilters.distance_phase_split(0.0077, radii, BINS)
    got = tfilters.distance_factors_split(_t(uh), _t(ul), _t(fr), BINS)
    want = jfilters.distance_factors_split(jnp.asarray(uh), jnp.asarray(ul), jnp.asarray(fr), BINS)
    for g, w in zip(got, want):
        assert g.shape == (64, BINS)
        assert _max_diff(g, w) <= TOL


def test_crossfade_tails_matches_jax():
    rng = np.random.default_rng(7)
    y_old = rng.standard_normal((5, 2, 128)).astype(np.float32)
    y_new = rng.standard_normal((5, 2, 128)).astype(np.float32)
    xf = np.array([True, False, True, True, False])
    got = tfilters.crossfade_tails(_t(y_old), _t(y_new), _t(xf))
    want = jfilters.crossfade_tails(jnp.asarray(y_old), jnp.asarray(y_new), jnp.asarray(xf))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[1].numpy(), y_new[1])


def test_xfade_ramp_is_the_true_quotient():
    fn = tfilters.xfade_ramp(128, "cpu")
    want = np.arange(128, dtype=np.float32) / np.float32(127)
    np.testing.assert_array_equal(fn.numpy(), want)
    assert fn[0] == 0 and fn[-1] == 1


def test_on_device_caches_tensor_planes():
    a = tfft.on_device(tfft._idft_tail_matrices, N, TAIL, device=torch.device("cpu"))
    b = tfft.on_device(tfft._idft_tail_matrices, N, TAIL, device=torch.device("cpu"))
    assert a is b
    np.testing.assert_array_equal(a[0].numpy(), jfft._idft_tail_matrices(N, TAIL)[0])
