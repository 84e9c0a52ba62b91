"""Row 12 under rows 5-7's pre-blend, on the CPU: ``blend_rows`` against
``blend_cat`` and the JAX package's ``blend_cat``
(``jefferson_tpu/engine/renderer.py``), the render callers that go
through it, the choices the Python side mirrors from ``csrc/dma_blend.cu``
(the dedup form's tile and column slices) and the forms' counts.  The
kernel's two forms run on the card only (``tests/test_torch_cuda.py`` holds
them bit for bit against each other and against ``blend_cat``).

Tolerance: ``blend_rows`` on the CPU is ``blend_cat``, bit for bit; XLA's
gathers on the CPU round each product and sum on its own too, so the JAX
``blend_cat`` agrees bit for bit on the same numpy inputs.
"""

import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jefferson_tpu.engine import renderer as jrenderer
from jefferson_tpu_torch import bench
from jefferson_tpu_torch.engine import batch as tbatch
from jefferson_tpu_torch.engine import renderer as trenderer
from jefferson_tpu_torch.engine.batch import BatchRenderer
from jefferson_tpu_torch.engine.renderer import Renderer
from jefferson_tpu_torch.hrtf.kemar import synthetic_database
from jefferson_tpu_torch.kernels import dma_blend as tdb
from jefferson_tpu_torch.kernels import fused_step as tfs

torch.set_num_threads(1)

SOURCE = (Path(__file__).resolve().parents[1] / "jefferson_tpu_torch" / "csrc"
          / "dma_blend.cu").read_text()


def _const(name: str) -> int:
    """An integer constexpr of csrc/dma_blend.cu, as its kernels see it."""
    value = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE).group(1)
    names = {k: _const(k) for k in re.findall(r"\b[A-Z][A-Z0-9_]*\b", value)}
    return int(eval(value.replace("/", "//"), {}, names))


def _held(n: int, every: int) -> np.ndarray:
    """A source that moves 5 degrees every ``every`` blocks: the dedup arm."""
    return np.stack([(np.arange(n) // every) * 5.0, np.zeros(n), np.ones(n)], 1)


def _operands(seed: int, rows: int, u: int = 710, c: int = 2052):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((u, c)).astype(np.float32)
    idx = rng.integers(0, u, (rows, 4)).astype(np.int32)
    w = rng.random((rows, 4)).astype(np.float32)
    return table, idx, w


@pytest.mark.parametrize("seed,rows", [(0, 1), (1, 33), (2, 264), (3, 2048)])
def test_blend_rows_on_the_cpu_is_blend_cat_and_the_jax_blend_cat(seed, rows):
    table, idx, w = _operands(seed, rows)
    t = torch.from_numpy
    got = tdb.blend_rows(t(table), t(idx), t(w))
    assert got.shape == (rows, 2052) and got.dtype == torch.float32
    assert torch.equal(got, tfs.blend_cat(t(table), t(idx), t(w)))
    want = np.asarray(jrenderer.blend_cat(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w)))
    assert np.array_equal(got.numpy(), want)


def test_blend_rows_takes_what_blend_cat_takes():
    """int64 ids, float64 weights and a (1, 4) row, as the renderers pass
    them: blend_cat's result; nothing is counted on the CPU."""
    table, idx, w = _operands(4, 5)
    t = torch.from_numpy
    before = tfs.launches["dma_blend"]
    got = tdb.blend_rows(t(table), t(idx).long(), t(w).double())
    assert torch.equal(got, tfs.blend_cat(t(table), t(idx).long(), t(w).double()))
    assert torch.equal(tdb.blend_rows(t(table), t(idx[:1]), t(w[:1])), got[:1])
    assert tfs.launches["dma_blend"] == before


def test_blend_rows_refuses_operands_it_does_not_take():
    table, idx, w = (torch.from_numpy(a) for a in _operands(5, 6))
    with pytest.raises(ValueError, match=r"\(U, C\) table"):
        tdb.blend_rows(table.reshape(-1), idx, w)
    with pytest.raises(ValueError, match=r"\(R, 4\)"):
        tdb.blend_rows(table, idx[:, :3], w[:, :3])
    with pytest.raises(ValueError, match=r"\(R, 4\)"):
        tdb.blend_rows(table, idx, w[:-1])
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tdb.blend_rows(table.to("meta"), idx.to("meta"), w.to("meta"))


@pytest.mark.parametrize("caller", ["single", "batched"])
def test_the_render_callers_blend_through_blend_rows(caller, monkeypatch):
    """Rows 5-7's pre-blend goes through blend_rows (row 12 on the card):
    the single-source dedup + fused chunks (renderer) and the batched gather
    chunks (batch) call it on every chunk, and the render is the one
    blend_cat gives."""
    db = synthetic_database()
    rng = np.random.default_rng(7)
    seen = []

    def spy(table, idx, w):
        seen.append(tuple(idx.shape))
        return tfs.blend_cat(table, idx, w)

    if caller == "single":
        pos, signal = _held(64, 20), (rng.standard_normal(64 * 128) * 0.2).astype(np.float32)
        make = lambda: Renderer(db, device="cpu", chunk_blocks=32)
        arm = "dedup_fused"
    else:
        pos = bench.wide_positions(8, 16)
        signal = (rng.standard_normal((8, 16 * 128)) * 0.2).astype(np.float32)
        make = lambda: BatchRenderer(db, device="cpu", chunk_blocks=16)
        arm = "gather_fused"
    want = make().render(signal, pos)
    monkeypatch.setattr(trenderer if caller == "single" else tbatch, "blend_rows", spy)
    r = make()
    got = r.render(signal, pos)
    assert np.array_equal(got, want)
    assert {a for a, _, _ in r.dispatch} == {arm}
    assert len(seen) >= len(r.dispatch) and all(shape[1] == 4 for shape in seen)


def test_the_dedup_forms_slices_mirror_the_kernel():
    assert (tdb.DEDUP_ROWS, tdb.DEDUP_W4) == (_const("DD_ROWS"), _const("DD_W4"))
    for c in (4, 128, 2052, 2176, 4096):
        slices = tdb.dedup_slices(c)
        assert [a for a, _ in slices] == [sum(w for _, w in slices[:i]) for i in range(len(slices))]
        assert sum(w for _, w in slices) == c and all(0 < w <= 4 * tdb.DEDUP_W4 for _, w in slices)
        assert len({w for _, w in slices[:-1]}) <= 1   # equal widths but the last
    assert tdb.dedup_slices(2176) == [(128 * i, 128) for i in range(17)]
    assert [w for _, w in tdb.dedup_slices(2052)] == [124] * 16 + [68]


def test_the_dedup_form_is_the_default_and_the_forms_are_counted_apart():
    assert inspect.signature(tdb._cuda).parameters["form"].default == tfs.DEDUP
    tfs.blend_forms[tfs.DEDUP] += 2
    tfs.row1_forms[tfs.STAGED] += 1
    tfs.reset_launches()
    assert set(tfs.blend_forms.values()) == {0} and set(tfs.row1_forms.values()) == {0}


def test_the_private_seam_refuses_an_unknown_blend_form():
    table, idx, w = (torch.from_numpy(a) for a in _operands(6, 4))
    with pytest.raises(ValueError, match="want 'double' or 'dedup'"):
        tdb._cuda(table, idx, w, 2052, form="pair")
