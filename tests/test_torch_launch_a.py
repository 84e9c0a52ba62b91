"""Launch A's forms (csrc/fused_forward.cuh) and row 9's lean wrapper, on the
CPU: the invariants the product form's epilogue relies on, the choices the
Python side mirrors (the few-block form's block threshold, the tiles' work
split, the shared-memory size), launch A's counts, bound and operands, and
row 9's operand checks.  The forms themselves run on the card only
(tests/test_torch_cuda.py holds them bit for bit against the tile form).

Tolerances: the port's per-triple distance planes equal its per-row planes
bit for bit; against the JAX package's ``_select_distance`` on the CPU they
agree within 2.4e-7 (XLA's and torch's cos differ by an ulp of the plane,
whose peak is the inverse distance factor <= 1).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jefferson_tpu.pallas import fused_step as jfs
from jefferson_tpu_torch import bench
from jefferson_tpu_torch.kernels import assoc_probe as tap
from jefferson_tpu_torch.kernels import fused_step as tfs
from jefferson_tpu_torch.ops.filters import distance_factors_split, distance_phase_split

torch.set_num_threads(1)

HEADER = (Path(__file__).resolve().parents[1] / "jefferson_tpu_torch" / "csrc"
          / "fused_forward.cuh").read_text()
GEO = dict(pad_len=1024, bins=513, fpb=128)


# the geometry the header's constants take without -D flags, the default
# library's (kernels/build.DEFAULT_GEOMETRY)
MACROS = {"JT_FPB": 128, "JT_PAD": 1024}


def _py(expr: str) -> str:
    """A C constant expression of the header as Python: conditionals
    (right-associative), &&, ||, !, sizeof(float), integer division."""
    expr = expr.strip()
    depth = 0
    for i, ch in enumerate(expr):
        depth += (ch == "(") - (ch == ")")
        if ch == "?" and depth == 0:
            nest, j, d = 0, i + 1, 0
            while True:  # the ':' of this '?'
                c = expr[j]
                d += (c == "(") - (c == ")")
                if d == 0 and c == "?":
                    nest += 1
                elif d == 0 and c == ":":
                    if not nest:
                        break
                    nest -= 1
                j += 1
            return f"(({_py(expr[i + 1:j])}) if ({_py(expr[:i])}) else ({_py(expr[j + 1:])}))"
    expr = expr.replace("&&", " and ").replace("||", " or ").replace("sizeof(float)", "4")
    return re.sub(r"!(?!=)", " not ", expr).replace("/", "//")


def _const(name: str) -> int:
    """An integer (or bool) constexpr of the forward header, as the kernels
    see it in the default library (fpb 128, pad 1024)."""
    if name in MACROS:
        return MACROS[name]
    value = " ".join(re.search(rf"constexpr (?:int|bool) {name} = ([^;]+);", HEADER)[1].split())
    names = {k: _const(k) for k in re.findall(r"\b[A-Z][A-Z0-9_]*\b", value)}
    return int(eval(_py(value), {}, names))


def _triples(n_dist, rows, seed):
    rng = np.random.default_rng(seed)
    radii = rng.uniform(0.3, 2.0, 8).astype(np.float32) / np.float32(10.0)
    uh, ul, fr = (torch.from_numpy(np.ascontiguousarray(a))
                  for a in distance_phase_split(0.005, radii, 513))
    sel = torch.from_numpy(rng.integers(-2, n_dist + 2, rows).astype(np.int32))
    return uh, ul, fr, sel


@pytest.mark.parametrize("n_dist", range(1, 9))
def test_per_triple_distance_planes_are_the_per_row_planes(n_dist):
    uh, ul, fr, sel = _triples(n_dist, 70, n_dist)
    assert ((sel < 1) | (sel >= n_dist)).any()  # some selectors outside 1..n_dist-1
    dr, di = distance_factors_split(uh, ul, fr, 513)
    t = torch.where((sel > 0) & (sel < n_dist), sel, 0).long()
    per_row = distance_factors_split(uh[t], ul[t], fr[t], 513)
    assert torch.equal(dr[t], per_row[0]) and torch.equal(di[t], per_row[1])
    jr, ji = jfs._select_distance(*(jnp.asarray(a.numpy()[:, None]) for a in (uh, ul, fr, sel)),
                                  n_dist, 70, 513)
    np.testing.assert_allclose(dr[t].numpy(), np.asarray(jr), rtol=0, atol=2.4e-7)
    np.testing.assert_allclose(di[t].numpy(), np.asarray(ji), rtol=0, atol=2.4e-7)


@pytest.mark.parametrize("n_dist", [1, 4, 8])
def test_the_twin_selects_each_rows_triple(n_dist):
    ops = bench.forward_operands(3, 5, "cpu", seed=n_dist, n_dist=n_dist)
    got = tfs._forward_reference(*ops, **GEO)
    dsel = ops[5][:, 0].long()
    t = torch.where((dsel > 0) & (dsel < n_dist), dsel, 0)
    uh, ul, fr = (a[t] for a in ops[2:5])
    want = tfs._forward_reference(ops[0], 5, uh, ul, fr, None, None, **GEO)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("nb,form", [
    (1, tfs.FWD_FEW), (2, tfs.FWD_FEW), (9, tfs.FWD_FEW), (10, tfs.FWD_PRODUCT),
    (64, tfs.FWD_PRODUCT), (256, tfs.FWD_PRODUCT), (2048, tfs.FWD_PRODUCT),
])
def test_launch_a_takes_the_few_block_form_up_to_few_nb(nb, form):
    assert tfs.forward_form(nb) == form


def test_the_few_block_threshold_and_triples_are_the_kernels():
    assert _const("FEW_NB") == tfs.FEW_NB
    assert _const("D_UNIQ") == tfs.MAX_DIST_UNIQ
    # the few-block kernel carries nb + 7 <= 16 rows a thread
    assert tfs.FEW_NB + _const("Q") - 1 <= 16


def _tiles(sources, nb):
    """The product form's work split, as forward_distance_product computes
    it: {(tile, slice): [(output row, the flat P rows it reads)]}."""
    q, g_out, g_rows = _const("Q"), _const("G_OUT"), _const("G_ROWS")
    length = nb + q - 1
    total = sources * length
    out = {}
    for tile in range((total - (q - 1) + g_out - 1) // g_out):
        g0 = tile * g_out
        n_out = min(g_out, total - (q - 1) - g0)
        rows = []
        for o in range(n_out):
            s, j = divmod(g0 + o, length)
            if j < nb:
                assert o + q - 1 < g_rows  # its window lies in the tile
                rows.append((s * nb + j, g0 + o))
        out[tile] = rows
    return out


@pytest.mark.parametrize("sources,nb", [(1, 1), (1, 9), (1, 57), (1, 58), (4, 66), (16, 256),
                                        (256, 64), (1, 12556)])
def test_the_product_forms_tiles_write_every_row_once(sources, nb):
    written = [row for rows in _tiles(sources, nb).values() for row, _ in rows]
    assert sorted(written) == list(range(sources * nb))
    for rows in _tiles(sources, nb).values():
        for row, g in rows:  # output row s*nb + j reads P rows g .. g+7 of its own source
            s, j = divmod(row, nb)
            assert g == s * (nb + _const("Q") - 1) + j


def test_the_product_forms_slices_and_shared_memory():
    assert _const("G_SLICES") * _const("G_KT") == 512  # bin 512 rides with the last slice
    assert _const("G_OUT") == _const("G_ROWS") - 7
    # four runs of G_RUN outputs cover a tile's outputs down each bin column
    assert 4 * _const("G_RUN") >= _const("G_OUT") > 3 * _const("G_RUN")
    # 256 threads hold G_RT rows x 4 bins of both planes over the tile, rows
    # rg + 16i of the 16 row groups
    assert _const("G_THREADS") * _const("G_RT") * 4 == _const("G_ROWS") * _const("G_KT")
    assert _const("G_RT") * 16 == _const("G_ROWS")
    floats = _const("G_BUF") + 2 * _const("D_UNIQ") * _const("G_DS")
    stages = 2 * (_const("G_ROWS") * _const("G_AS") + _const("G_KC") * 2 * _const("G_KT")
                  + 2 * _const("G_KC"))
    assert _const("G_BUF") == max(stages, 2 * _const("G_ROWS") * _const("G_PS"))
    assert 4 * floats <= 232448 // 3  # three CTAs an SM


def test_the_seam_refuses_what_it_does_not_take():
    ops = bench.forward_operands(1, 4, "cpu", seed=0)
    with pytest.raises(ValueError, match="form"):
        tfs._forward_cuda(*ops, form="tiles", **GEO)
    big = bench.forward_operands(1, tfs.FEW_NB + 1, "cpu", seed=0)
    with pytest.raises(ValueError, match="few-block form takes at most"):
        tfs._forward_cuda(*big, form=tfs.FWD_FEW, **GEO)
    with pytest.raises(ValueError, match="on the card"):
        tfs._forward_cuda(*ops, form=tfs.FWD_PRODUCT, **GEO)
    assert not any(tfs.forward_launches.values())


def test_reset_sets_launch_as_counts_to_0():
    tfs.forward_launches[tfs.FWD_PRODUCT] = 3
    tfs.reset_launches()
    assert tfs.forward_launches == dict.fromkeys(
        (tfs.FWD_TILE, tfs.FWD_PRODUCT, tfs.FWD_FEW, tfs.FWD_PLANES), 0)


@pytest.mark.parametrize("sources,nb,want_ms", [
    (256, 64, 0.0790), (16, 256, 0.0184), (1, 2048, 0.0090), (1, 12556, 0.0552),
])
def test_launch_as_bound_is_the_steps_forward_term(sources, nb, want_ms):
    forward = bench.forward_flops(sources, nb)
    assert forward == (bench.step_flops("fused_step_xfade", sources, nb)
                       - bench.step_flops("fused_apply_xfade", sources, nb))
    ms, by = bench.bound_ms(forward, bench.forward_bytes(sources, nb))
    assert by == "operations" and round(ms, 4) == want_ms


def test_launch_as_bytes_count_each_operand_once():
    rows = 3 * 5
    per_row = 4 * (3 * 12 * 128 + 2 * 128 * 513 + 2 * 8 * 513 + 2 * rows * 513) + 3 * rows * 4
    assert bench.forward_bytes(3, 5) == per_row
    assert bench.forward_bytes(3, 5, n_dist=2) == per_row - 3 * rows * 4 + 3 * 2 * 4 + rows * 4


@pytest.mark.parametrize("n_dist", [None, 3])
def test_forward_operands(n_dist):
    streams, nb, uh, ul, fr, dsel, n = bench.forward_operands(2, 6, "cpu", seed=1, n_dist=n_dist)
    assert streams.shape == (2, 7 * 128 + 6 * 128) and nb == 6 and n == n_dist
    assert uh.shape == ul.shape == fr.shape == ((12 if n_dist is None else 8), 1)
    if n_dist is None:
        assert dsel is None
    else:
        assert dsel.shape == (12, 1) and dsel.dtype == torch.int32
        assert int(dsel.min()) >= -2 and int(dsel.max()) <= n_dist + 1


# ---- row 9's wrapper ----------------------------------------------------------

def _planes(rows=6, k=5, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((rows, k)).astype(np.float32)) for _ in range(4)]


BAD = {
    "shape": lambda t: t[:, :4].contiguous(),
    "dtype": lambda t: t.double(),
    "layout": lambda t: t.t().contiguous().t(),
}


@pytest.mark.parametrize("which", range(4))
@pytest.mark.parametrize("bad", list(BAD))
def test_prod_refuses_a_plane_it_does_not_take(which, bad):
    planes = _planes()
    planes[which] = BAD[bad](planes[which])
    name = ("xr", "xi", "gr", "gi")[which]
    # a bad xr sets the shape the others are held to
    with pytest.raises(ValueError, match="want contiguous"):
        tap.prod(*planes)
    if which:
        with pytest.raises(ValueError, match=f"{name}: want contiguous"):
            tap.prod(*planes)


@pytest.mark.parametrize("which", range(4))
def test_prod_refuses_mixed_devices(which):
    planes = _planes()
    planes[which] = torch.empty(planes[which].shape, device="meta")
    with pytest.raises(ValueError, match="one device"):
        tap.prod(*planes)


def test_prod_on_the_cpu_is_its_twin_uncounted():
    tfs.reset_launches()
    planes = _planes()
    got = tap.prod(*planes)
    want = tap.prod_reference(*planes)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tfs.launches["prod"] == 0
    with pytest.raises(ValueError, match="no kernel"):
        tap.prod(*(torch.empty((2, 3), device="meta") for _ in range(4)))
