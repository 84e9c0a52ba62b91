"""The CUDA step on a card: against its plain twin, inside the renderer, and
its operand checks.  Every test needs a CUDA device and skips without one.

This file imports no jax, so a machine without jax runs it on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from jefferson_tpu import DEFAULT_CONFIG, synthetic_database
from jefferson_tpu_torch import bench
from jefferson_tpu_torch.engine.batch import BatchRenderer
from jefferson_tpu_torch.kernels import fused_step as tfs

pytestmark = pytest.mark.cuda

TOL = 5e-7  # kernel vs twin: fp32 DFT sums in another order


@pytest.fixture(scope="module")
def card_db():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return synthetic_database(DEFAULT_CONFIG)


def _operands(db, radius_step, s=4, nb=16):
    wl = bench.build_workload(db, s, nb, torch.device("cuda", 0), radius_step=radius_step)
    return bench.step_operands(wl, DEFAULT_CONFIG)


@pytest.mark.parametrize("radius_step", [0.0, 0.05])
def test_kernel_matches_twin(card_db, radius_step):
    args, kw = _operands(card_db, radius_step)
    before = tfs.launches
    got = tfs.fused_step_onehot_xfade(*args, **kw)
    torch.cuda.synchronize()
    assert tfs.launches == before + 1
    want = tfs.fused_step_onehot_xfade_reference(*args, **kw)
    assert got.shape == want.shape == (64, 256)
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("s,nb,radius_step", [
    (1, 1, 0.0), (3, 5, 0.05), (2, 33, 0.0), (1, 256, 0.05), (7, 40, 0.0),
])
def test_kernel_matches_twin_at_ragged_shapes(card_db, s, nb, radius_step):
    """Block counts that are not a multiple of the kernels' 32-row tiles."""
    args, kw = _operands(card_db, radius_step, s, nb)
    got = tfs.fused_step_onehot_xfade(*args, **kw)
    want = tfs.fused_step_onehot_xfade_reference(*args, **kw)
    assert got.shape == (s * nb, 256)
    assert float((got - want).abs().max()) <= TOL


def test_kernel_matches_twin_on_ids_outside_the_table(card_db):
    args, kw = _operands(card_db, 0.0)
    args = list(args)
    u = args[4].shape[0]
    args[5] = args[5].clone()
    args[5][3, 1], args[5][17, 0] = u + 2, -4
    kw = {**kw, "dsel": kw["dsel"].clone()}
    kw["dsel"][9, 0] = 7
    got = tfs.fused_step_onehot_xfade(*args, **kw)
    want = tfs.fused_step_onehot_xfade_reference(*args, **kw)
    assert float((got - want).abs().max()) <= TOL


def test_render_on_the_card_matches_the_cpu_twin(card_db):
    signals, positions = bench.moving_scene(3, 37, DEFAULT_CONFIG)
    before = tfs.launches
    got = BatchRenderer(card_db, device="cuda", chunk_blocks=16).render(signals, positions)
    assert tfs.launches == before + 3
    want = BatchRenderer(card_db, device="cpu", chunk_blocks=16).render(signals, positions)
    assert np.abs(got - want).max() <= TOL


def test_kernel_refuses_operands_it_does_not_take(card_db):
    args, kw = _operands(card_db, 0.0)
    bad = list(args)
    bad[6] = args[6].double()
    with pytest.raises(ValueError, match="w: want contiguous"):
        tfs.fused_step_onehot_xfade(*bad, **kw)
    bad = list(args)
    bad[5] = args[5].t().contiguous().t()
    with pytest.raises(ValueError, match="ridx: want contiguous"):
        tfs.fused_step_onehot_xfade(*bad, **kw)
    with pytest.raises(ValueError, match="built for fpb=128"):
        tfs.fused_step_onehot_xfade(*args, **{**kw, "bins": 257})
