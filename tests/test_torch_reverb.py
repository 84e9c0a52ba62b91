"""The port's convolution reverb against the JAX package's, on the CPU.

Every case of tests/test_reverb.py in the port's two backends, ``host``
(scipy float64, the JAX module's own arithmetic: bit-equal) and ``device``
(the partitioned convolution on the caller's device, here the CPU), each
function also held against its JAX original on the same inputs: the
``device`` backend to the JAX ``tpu`` backend within 5e-6 (two fp32
partitioned convolutions, each up to about 2e-6 from the float64 answer at
outputs of peak 1.5), ``reverb_oracle`` bit for bit.
"""

import numpy as np
import pytest
import torch

from jefferson_tpu.reverb import convolution as jrev
from jefferson_tpu_torch.reverb.convolution import (
    StreamingConvolver,
    convolve_linear,
    reverb_oracle,
    reverb_reference,
)

torch.set_num_threads(1)

BACKENDS = ["host", "device"]
JAX_BACKEND = {"host": "host", "device": "tpu"}
TOL_JAX = 5e-6


@pytest.fixture(scope="module")
def dry():
    rng = np.random.default_rng(10)
    return (rng.standard_normal(20_000) * 0.2).astype(np.float32)


@pytest.fixture(scope="module")
def ir():
    rng = np.random.default_rng(11)
    n = 4_500  # not a multiple of the partition
    env = np.exp(-np.arange(n) / 600.0)
    return (rng.standard_normal(n) * env * 0.1).astype(np.float32)


def _vs_jax(got, want, backend):
    if backend == "host":
        np.testing.assert_array_equal(got, want)
    else:
        assert got.shape == want.shape
        assert np.max(np.abs(got - want)) <= TOL_JAX


@pytest.mark.parametrize("backend", BACKENDS)
def test_linear_convolution_matches_numpy(dry, ir, backend):
    want = np.convolve(dry.astype(np.float64), ir.astype(np.float64))
    got = convolve_linear(dry, ir, backend=backend, device="cpu")
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.max(np.abs(got - want)) < 5e-5
    _vs_jax(got, jrev.convolve_linear(dry, ir, backend=JAX_BACKEND[backend]), backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_short_ir_and_short_signal(backend):
    sig = np.ones(100, np.float32)
    ir = np.array([1.0, 0.5], np.float32)
    got = convolve_linear(sig, ir, backend=backend, device="cpu")
    np.testing.assert_allclose(got, np.convolve(sig, ir), atol=1e-5)
    _vs_jax(got, jrev.convolve_linear(sig, ir, backend=JAX_BACKEND[backend]), backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_reference_reverb_matches_oracle(dry, ir, backend):
    got = reverb_reference(dry, ir, normalize=False, backend=backend, device="cpu")
    want = reverb_oracle(dry, ir, normalize=False)
    assert got.shape == want.shape == (len(dry) + len(ir) - len(ir) // 2,)
    assert np.max(np.abs(got - want)) < 5e-5
    _vs_jax(got, jrev.reverb_reference(dry, ir, normalize=False,
                                       backend=JAX_BACKEND[backend]), backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_circular_wrap_semantics(dry, ir, backend):
    lin = np.convolve(dry.astype(np.float64), ir.astype(np.float64))
    new_size = len(dry) + len(ir) - len(ir) // 2
    want = lin[:new_size].copy()
    want[: len(lin) - new_size] += lin[new_size:]
    got = reverb_reference(dry, ir, normalize=False, backend=backend, device="cpu")
    assert np.max(np.abs(got - want)) < 5e-5


@pytest.mark.parametrize("backend", BACKENDS)
def test_rms_normalization(dry, ir, backend):
    out = reverb_reference(dry, ir, normalize=True, backend=backend, device="cpu")
    rms_in = np.sqrt(np.mean(dry.astype(np.float64) ** 2))
    rms_out = np.sqrt(np.mean(out.astype(np.float64) ** 2))
    np.testing.assert_allclose(rms_out, rms_in, rtol=1e-4)
    _vs_jax(out, jrev.reverb_reference(dry, ir, normalize=True,
                                       backend=JAX_BACKEND[backend]), backend)


def test_streaming_convolver_matches_offline(dry, ir):
    part = 1024
    conv = StreamingConvolver(ir, partition=part, device="cpu")
    jconv = jrev.StreamingConvolver(ir, partition=part)
    n_chunks = len(dry) // part
    chunks = [dry[i * part : (i + 1) * part] for i in range(n_chunks)]
    chunks += [np.zeros(part, np.float32)] * (len(ir) // part + 2)  # flush the tail
    outs, jouts = [], []
    for c in chunks:
        outs.append(conv.process(c))
        jouts.append(jconv.process(c))
    got = np.concatenate(outs)
    want = np.convolve(dry[: n_chunks * part].astype(np.float64), ir.astype(np.float64))
    m = min(len(got), len(want))
    assert np.max(np.abs(got[:m] - want[:m])) < 5e-5
    assert np.max(np.abs(got - np.concatenate(jouts))) <= TOL_JAX


def test_streaming_convolver_rejects_oversized_chunk():
    conv = StreamingConvolver(np.ones(64, np.float32), partition=32, device="cpu")
    with pytest.raises(ValueError, match="exceeds the partition"):
        conv.process(np.zeros(33, np.float32))


@pytest.mark.parametrize("backend", BACKENDS)
def test_one_tap_ir_matches_oracle(backend):
    rng = np.random.default_rng(2)
    dry = rng.standard_normal(300).astype(np.float32) * 0.3
    ir1 = np.array([0.7], np.float32)
    got = reverb_reference(dry, ir1, normalize=False, backend=backend, device="cpu")
    want = reverb_oracle(dry, ir1, normalize=False)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-6)


@pytest.mark.parametrize("backend", BACKENDS)
def test_empty_ir_rejected(backend):
    dry = np.ones(100, np.float32)
    with pytest.raises(ValueError, match="empty"):
        convolve_linear(dry, np.zeros(0, np.float32), backend=backend, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        StreamingConvolver(np.zeros(0, np.float32), partition=64, device="cpu")


def test_streaming_state_stays_on_device(dry, ir):
    """The IR spectra, the spectral ring and the overlap are tensors on the
    convolver's device, uploaded once; prime() leaves the state as it was."""
    conv = StreamingConvolver(ir, partition=256, device="cpu")
    conv.prime()
    assert not conv._ring_r.any() and not conv._overlap.any()
    conv.process(dry[:256])
    for name in ("_hr", "_hi", "_ring_r", "_ring_i", "_overlap"):
        t = getattr(conv, name)
        assert isinstance(t, torch.Tensor) and t.device == conv.device, name
    assert conv._ring_r.any()


def test_reverb_oracle_normalize_restores_input_rms(dry, ir):
    wet = reverb_oracle(dry, ir, normalize=True)
    np.testing.assert_array_equal(wet, jrev.reverb_oracle(dry, ir, normalize=True))
    rms_in = float(np.sqrt(np.mean(np.asarray(dry, np.float64) ** 2)))
    rms_wet = float(np.sqrt(np.mean(np.asarray(wet, np.float64) ** 2)))
    assert abs(rms_wet - rms_in) < 1e-4 * max(rms_in, 1e-9)
    raw = reverb_oracle(dry, ir, normalize=False)
    np.testing.assert_array_equal(raw, jrev.reverb_oracle(dry, ir, normalize=False))
    assert not np.allclose(raw, wet)


def test_backends_are_named_and_nothing_falls_back(dry, ir):
    """"device" runs on the caller's device and raises without a card; an
    unknown backend (the JAX package's "tpu") is refused."""
    with pytest.raises(ValueError, match="unknown reverb backend 'tpu'"):
        convolve_linear(dry, ir, backend="tpu", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            convolve_linear(dry, ir, backend="device")
        with pytest.raises(RuntimeError, match="is_available"):
            StreamingConvolver(ir)
