"""The arms ``chip_smoke.py`` holds the card's scene path to, at full size
(16 sources x 12,544 blocks): both BatchRenderers plan every chunk with
their chunk functions stubbed out (each returns zeros of the chunk's
shape), so only the planning runs, and they take the same arm on every
chunk.  The JAX arms are read off its ``_get_fn`` calls, one per chunk."""

import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jefferson_tpu.engine import batch as jbatch
from jefferson_tpu_torch import bench
from jefferson_tpu_torch.convert import database_from_numpy
from jefferson_tpu_torch.engine import batch as tbatch

from test_torch_batch import record_jax_arms

torch.set_num_threads(1)

FACTORIES = ("batched_chunk_fn_dedup_fused", "batched_chunk_fn_fused", "batched_chunk_fn",
             "batched_chunk_fn_dedup")


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.fixture(scope="module")
def smoke():
    return _smoke()


@pytest.fixture(scope="module")
def scene_sets(smoke):
    return smoke.scene_positions(bench)


@pytest.mark.parametrize("name", list(_smoke().scenes()))
def test_full_size_scene_dispatch_matches_jax(db, config, smoke, scene_sets, name, monkeypatch):
    fpb = config.frames_per_buffer
    for f in FACTORIES:
        monkeypatch.setattr(jbatch, f, lambda cfg, nb, *a, **k: (
            lambda spectra, hists, *args, **kw: (
                jnp.zeros((hists.shape[0], nb, fpb, 2), jnp.float32), hists)))
        monkeypatch.setattr(tbatch, f, lambda cfg, nb, *a, **k: (
            lambda spectra, hists, *args, **kw: (torch.zeros(hists.shape[0], nb, fpb, 2), hists)))
    pset, cb, opts, arm, _ = smoke.scenes()[name]
    positions, _ = scene_sets[pset]
    assert positions.shape[:2] == (16, 12544)
    signals = np.zeros((16, 4096), np.float32)
    r = jbatch.BatchRenderer(db, chunk_blocks=cb, fused=True, mix=True, **opts)
    jax_arms = record_jax_arms(r)
    r.render(signals, positions)
    tdb = database_from_numpy(db.spectra, db.hrirs, dataclasses.asdict(db.config))
    port = tbatch.BatchRenderer(tdb, device="cpu", chunk_blocks=cb, mix=True, **opts)
    port.render(signals, positions)
    assert len(port.dispatch) == -(-12544 // cb)
    assert port.dispatch == jax_arms == [arm] * len(port.dispatch)
    assert set(port.timings) == {"planning_s", "chunks_s"}
