"""The port's live CLI (``python -m jefferson_tpu_torch.rt``) on the CPU
(``--device cpu``, the kernels' twins), held to the JAX package's
``python -m jefferson_tpu.rt`` on the same input: the output WAV within
5e-7 (TOL_JAX), dry and with the live reverb; and its refusals.
"""

import numpy as np
import pytest
import torch

from jefferson_tpu.rt.__main__ import main as jrt_main
from jefferson_tpu_torch.io.wavio import read_wav, write_wav
from jefferson_tpu_torch.rt.__main__ import main as trt_main

torch.set_num_threads(1)

TOL_JAX = 5e-7


@pytest.fixture
def wavs(tmp_path, castanets, config):
    src, ir = tmp_path / "in.wav", tmp_path / "ir.wav"
    write_wav(src, castanets[:20000], config.sample_rate, bits=32, float_format=True)
    rng = np.random.default_rng(5)
    taps = (rng.standard_normal(900) * np.exp(-np.arange(900) / 200.0) * 0.1)
    taps[0] = 1.0
    write_wav(ir, taps.astype(np.float32), config.sample_rate, bits=32, float_format=True)
    return src, ir


@pytest.mark.parametrize("extra", [[], ["--trajectory", "static:azi=40,ele=10,r=1.5"],
                                   ["--reverb", "IR"]], ids=["orbit", "static", "reverb"])
def test_rt_equals_the_jax_rt(tmp_path, wavs, extra, capsys):
    src, ir = wavs
    extra = [str(ir) if a == "IR" else a for a in extra]
    common = ["-i", str(src), "--seconds", "1", *extra]
    assert trt_main([*common, "-o", str(tmp_path / "t.wav"), "--device", "cpu"]) == 0
    assert jrt_main([*common, "-o", str(tmp_path / "j.wav"), "--device", "cpu"]) == 0
    got, sr = read_wav(tmp_path / "t.wav")
    want, _ = read_wav(tmp_path / "j.wav")
    n = int(np.ceil(1.0 / (128 / 44100)))
    assert sr == 44100 and got.shape == want.shape == (n * 128, 2)
    assert np.abs(got).max() > 0
    assert float(np.abs(got - want).max()) <= TOL_JAX
    assert "deadline misses" in capsys.readouterr().err


def test_rt_refuses_zero_seconds_and_an_empty_wav(tmp_path, wavs):
    src, _ = wavs
    with pytest.raises(SystemExit, match="--seconds must be > 0"):
        trt_main(["-i", str(src), "--seconds", "0", "--device", "cpu",
                  "-o", str(tmp_path / "o.wav")])
    empty = tmp_path / "empty.wav"
    write_wav(empty, np.zeros(0, np.float32), 44100)
    with pytest.raises(SystemExit, match="is empty"):
        trt_main(["-i", str(empty), "--device", "cpu", "-o", str(tmp_path / "o.wav")])
    with pytest.raises(SystemExit, match="unknown trajectory kind"):
        trt_main(["-i", str(src), "--trajectory", "nope", "--device", "cpu",
                  "-o", str(tmp_path / "o.wav")])


def test_rt_default_device_raises_without_a_card(tmp_path, wavs):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    src, _ = wavs
    with pytest.raises(SystemExit, match="--device cuda: .*is_available"):
        trt_main(["-i", str(src), "-o", str(tmp_path / "o.wav")])
    assert not (tmp_path / "o.wav").exists()
