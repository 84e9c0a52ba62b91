"""The port's viz copies (``jefferson_tpu_torch/viz/``) pinned byte for byte
to the JAX package's: every drawing function on the same seeded inputs
writes or returns the same bytes.

The HTML players embed a 16-bit WAV; the JAX ``io.wavio`` takes its native
extension where it is built, so the pins switch it off, as
tests/test_torch_rt.py does (tests/test_wavio.py holds its two arms within
one LSB).
"""

import json

import numpy as np
import pytest
import torch

from jefferson_tpu.io import wavio as jwavio
from jefferson_tpu.viz import html as jhtml
from jefferson_tpu.viz import live as jlive
from jefferson_tpu.viz import scene as jscene
from jefferson_tpu.viz import scene3d as jscene3d
from jefferson_tpu_torch.config import DEFAULT_CONFIG
from jefferson_tpu_torch.trajectory.trajectory import CircularOrbit
from jefferson_tpu_torch.viz import html as thtml
from jefferson_tpu_torch.viz import live as tlive
from jefferson_tpu_torch.viz import scene as tscene
from jefferson_tpu_torch.viz import scene3d as tscene3d

torch.set_num_threads(1)


def _inputs(seed: int, blocks: int = 48):
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(0, 360, blocks), rng.uniform(-40, 90, blocks),
                    rng.uniform(0.3, 3.0, blocks)], axis=1)
    samples = (rng.standard_normal((blocks * 128, 2)) * 0.3).astype(np.float32)
    return pos, samples


def _status(seed: int, alive=True) -> dict:
    rng = np.random.default_rng(seed)
    x, y, z = rng.uniform(-1, 1, 3)
    return {"ok": True, "x": x, "y": y, "z": z, "azi": float(rng.uniform(0, 360)),
            "ele": float(rng.uniform(-40, 90)), "r": float(rng.uniform(0.2, 2)),
            "blocks": int(rng.integers(0, 300)), "total_blocks": 344, "alive": alive,
            "clipping": bool(seed % 2)}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fn", ["scene_svg", "waveform_svg", "scene_html", "scene3d_html"])
def test_file_views_write_the_same_bytes(tmp_path, monkeypatch, fn, seed):
    monkeypatch.setattr(jwavio, "_nat", None)
    pos, samples = _inputs(seed)
    if seed:  # a real trajectory, and a waveform shorter than the bins
        pos = CircularOrbit(period_s=0.3, ele=20, r=1.5).sample(48, DEFAULT_CONFIG)
        samples = samples[:500]
    mods = {"scene_svg": (jscene, tscene), "waveform_svg": (jscene, tscene),
            "scene_html": (jhtml, thtml), "scene3d_html": (jscene3d, tscene3d)}[fn]
    args = {"scene_svg": (pos,), "waveform_svg": (samples,)}.get(fn, (pos, samples))
    for mod, name in zip(mods, ("jax", "torch")):
        getattr(mod, fn)(*args, tmp_path / f"{name}.out")
    assert (tmp_path / "torch.out").read_bytes() == (tmp_path / "jax.out").read_bytes()


def test_decimate_waveform_is_equal():
    rng = np.random.default_rng(3)
    for n in (10, 1024, 5000):
        x = rng.standard_normal(n).astype(np.float32)
        np.testing.assert_array_equal(tscene.decimate_waveform(x, bins=64),
                                      jscene.decimate_waveform(x, bins=64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_live_views_return_the_same_strings(seed):
    st = _status(seed, alive=seed != 2)
    trail = [tuple(p) for p in np.random.default_rng(seed).uniform(-1, 1, (seed * 5, 2))]
    trail3 = np.random.default_rng(seed + 9).uniform(-1, 1, (seed * 4, 3)).tolist()
    assert tlive.live_scene_svg(st, trail) == jlive.live_scene_svg(st, trail)
    assert tlive.live_scene_svg(st) == jlive.live_scene_svg(st)
    assert tlive.live_html(f"s{seed}.svg", 40 * seed + 50) == jlive.live_html(
        f"s{seed}.svg", 40 * seed + 50)
    assert tscene3d.live3d_html(f"s{seed}.json", 100 + seed) == jscene3d.live3d_html(
        f"s{seed}.json", 100 + seed)
    assert json.dumps(tscene3d.live3d_state(st, trail3)) == json.dumps(
        jscene3d.live3d_state(st, trail3))
    assert tlive._audio_space_xz(st) == jlive._audio_space_xz(st)
