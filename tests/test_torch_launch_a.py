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
        (tfs.FWD_TILE, tfs.FWD_PRODUCT, tfs.FWD_FEW, tfs.FWD_PLANES, tfs.FWD_RING), 0)


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


# ---- launch A's ring form -----------------------------------------------------

# geometries past Q 16: fpb 16, 4 and 2 under pad 1024 (Q 64, 256, 512), fpb
# 32 under pad 4096 (Q 128, no product form), fpb 4 under pad 4096 (Q
# 1,024), fpb 128 under pad 4096 (Q 32, the product form's), fpb 2 under
# pad 64 (33 bins: one slice and bin 32)
_RING_GEOS = [(16, 1024), (4, 1024), (2, 1024), (32, 4096), (4, 4096), (128, 4096), (2, 64)]


def test_the_ring_form_is_named_and_coded_as_the_header():
    enum = re.search(r"enum ForwardForm \{([^}]*)\}", HEADER)[1]
    codes = {k: int(v) for k, v in re.findall(r"(FWD_\w+) = (\d+)", enum)}
    assert tfs.FWD_RING == "ring" and codes["FWD_RING"] == tfs._FWD_CODE[tfs.FWD_RING] == 4
    assert codes["FWD_PLANES"] == tfs._FWD_CODE[tfs.FWD_PLANES]
    assert codes["FWD_PLANES_DFT"] == tfs._PLANES_PART_CODE[tfs.PLANES_DFT]
    assert codes["FWD_PLANES_SUM"] == tfs._PLANES_PART_CODE[tfs.PLANES_SUM]
    assert set(tfs.forward_launches) == set(tfs._FWD_CODE)


@pytest.mark.parametrize("fpb,pad", [*_RING_GEOS, (128, 1024), (64, 1024), (8, 128), (16, 256),
                                     (2048, 4096), (100, 1024)])
def test_the_ring_form_exists_where_the_header_builds_it(monkeypatch, fpb, pad):
    monkeypatch.setitem(MACROS, "JT_FPB", fpb)
    monkeypatch.setitem(MACROS, "JT_PAD", pad)
    forms = tfs.geometry_forms(fpb, pad)
    assert bool(_const("HAS_RING")) == forms.ring == (forms.q > tfs.TILE_MAX_Q)
    assert not (forms.ring and forms.tile)  # exactly where the tile form stops


@pytest.mark.parametrize("fpb,pad", [*_RING_GEOS, (64, 8192), (128, 16384)])
def test_the_steps_take_the_ring_form_where_they_took_the_planes_form(fpb, pad):
    """Up to fpb 32 the ring form, which needs no scratch; past it (Q above
    64, no product form) the ring form where it pays, else the planes form
    and its scratch, as before."""
    forms = tfs.geometry_forms(fpb, pad)
    for sources in (1, 2, 16):
        for nb in (1, 2, 9, 64, 300):
            form = tfs.forward_form(nb, fpb, pad, sources)
            scratch = tfs.planes_scratch(sources, nb, fpb, pad, "cpu")
            if nb <= forms.few_nb:
                assert form == tfs.FWD_FEW
            elif forms.product:
                assert form == tfs.FWD_PRODUCT
            elif fpb <= tfs.RING_MAX_FPB or tfs.ring_pays(sources, nb, fpb, pad):
                assert form == tfs.FWD_RING and scratch == (None, None)
            else:
                assert form == tfs.FWD_PLANES
                assert all(t.shape == (sources * (nb + forms.q - 1), forms.bins)
                           for t in scratch)


def test_the_planes_form_is_taken_only_past_the_ring_forms_blocks():
    assert _const("RING_MAX_FPB") == tfs.RING_MAX_FPB
    for pad in (2, 4, 16, 64, 256, 1024, 4096, 16384):
        for fpb in (2, 4, 8, 16, 32, 64, 128, 256, 512):
            if fpb <= pad:
                for sources in (1, 2, 16):
                    for nb in (1, 9, 300):
                        planes = tfs.forward_form(nb, fpb, pad, sources) == tfs.FWD_PLANES
                        forms = tfs.geometry_forms(fpb, pad)
                        assert planes == (fpb > tfs.RING_MAX_FPB and not forms.product
                                          and not forms.tile and nb > forms.few_nb
                                          and not tfs.ring_pays(sources, nb, fpb, pad))


# Launch A's device time alone, ring / planes ms, at the geometries past
# RING_MAX_FPB with a ring form and no product form: (fpb, pad) -> (S, nb)
# -> (ring, planes) (scripts/tail_times.py --launch-a-forms on an H100,
# 700 W; kernels/fused_step.py RING_MAX_FPB)
RING_READINGS = {
    (64, 8192): {(16, 256): (1.3113, 1.5594), (16, 64): (0.4064, 0.7759),
                 (1, 2048): (0.6669, 0.5954), (1, 1): (0.0293, 0.0507)},
    (64, 16384): {(16, 256): (4.4314, 7.9023), (16, 64): (1.4267, 4.7949),
                  (1, 2048): (2.2599, 2.1831), (1, 1): (0.1143, 0.1632)},
    (128, 16384): {(16, 256): (3.7229, 3.7381), (16, 64): (1.1634, 1.8158),
                   (1, 2048): (1.9094, 1.3849), (1, 1): (0.0955, 0.0711)},
    (128, 32768): {(16, 256): (12.3229, 17.6079), (16, 64): (4.0205, 10.6559),
                   (1, 2048): (6.2213, 4.7721), (1, 1): (0.3118, 0.2537)},
    (256, 32768): {(16, 256): (12.5574, 10.7793), (16, 64): (4.4599, 5.2719),
                   (1, 2048): (6.3556, 3.8689), (1, 1): (0.3408, 0.1934)},
    (512, 65536): {(16, 256): (51.8824, 30.8404), (16, 64): (16.4849, 15.0841),
                   (1, 2048): (26.0050, 10.9435), (1, 1): (1.1297, 0.5981)},
}


@pytest.mark.parametrize("fpb,pad", list(RING_READINGS))
def test_the_ring_form_is_taken_past_fpb_32_only_where_it_won(fpb, pad):
    """Past RING_MAX_FPB the steps take the ring form at a shape only where
    it took less than the planes form by more than RUN_SPREAD, and never
    where it lost or tied."""
    from jefferson_tpu_torch.scripts.split_layouts import RUN_SPREAD

    forms = tfs.geometry_forms(fpb, pad)
    assert fpb > tfs.RING_MAX_FPB and forms.ring and not forms.product
    for (sources, nb), (ring, planes) in RING_READINGS[(fpb, pad)].items():
        if tfs.forward_form(nb, fpb, pad, sources) == tfs.FWD_RING:
            assert ring < planes * (1 - RUN_SPREAD)
        if ring >= planes * (1 - RUN_SPREAD):
            assert tfs.forward_form(nb, fpb, pad, sources) == tfs.FWD_PLANES


# the ring form's shapes (csrc/fused_forward.cuh): run T -> (outputs a
# thread V, runs down a bin, CTAs an SM)
RING_SHAPES = {int(t): tuple(map(int, a)) for t, *a in re.findall(
    r"using Ring(\d+) = Ring<(\d+), (\d+), (\d+)>;", HEADER)}


def test_the_ring_forms_shapes_are_their_runs():
    assert sorted(RING_SHAPES) == [4, 16, 64, 128]
    for t, (v, runs, ctas) in RING_SHAPES.items():
        assert v * runs == t and 32 * runs * ctas <= 2048   # threads an SM


def _ring_split(sources, nb, v, runs, fpb, pad, monkeypatch):
    """The ring form's work split, as forward_distance_ring computes it from
    the header's constants: {(output row, bin): [the source's P rows its
    window reads]} over every CTA and thread, bin 512 with the last slice."""
    monkeypatch.setitem(MACROS, "JT_FPB", fpb)
    monkeypatch.setitem(MACROS, "JT_PAD", pad)
    q, bins, kt = _const("Q"), _const("BINS"), _const("R_KT")
    slices, nyq, mc = _const("R_SLICES"), bool(_const("R_NYQ")), _const("R_MC")
    t = v * runs
    ring = 1 << (mc + t - 2).bit_length()
    assert ring >= mc + t - 1 and q % mc == 0   # the rows a chunk reads fit
    tiles = -(-nb // t)
    out = {}
    for cta in range(slices * tiles * sources):
        sl, tile, s = cta % slices, cta // slices % tiles, cta // slices // tiles
        j0, k0 = tile * t, sl * kt
        for tid in range(runs * kt):
            col, run = tid % kt, tid // kt
            for o in range(v):
                j, k = j0 + run * v + o, k0 + col
                if j < nb and k < bins:
                    out.setdefault((s * nb + j, k), []).append([j + m for m in range(q)])
            if nyq and sl == slices - 1 and tid < t and j0 + tid < nb:
                j = j0 + tid
                out.setdefault((s * nb + j, bins - 1), []).append([j + m for m in range(q)])
    return out, bins, q


@pytest.mark.parametrize("fpb,pad", [(16, 1024), (4, 1024), (2, 64), (32, 4096)])
@pytest.mark.parametrize("sources,nb", [(1, 1), (3, 88), (2, 70), (1, 130)])
@pytest.mark.parametrize("t", [4, 16, 64, 128])
def test_the_ring_forms_ctas_write_every_output_once_inside_its_source(
        monkeypatch, fpb, pad, sources, nb, t):
    v, runs, _ = RING_SHAPES[t]
    split, bins, q = _ring_split(sources, nb, v, runs, fpb, pad, monkeypatch)
    assert sorted(split) == [(r, k) for r in range(sources * nb) for k in range(bins)]
    for (row, _), windows in split.items():
        assert len(windows) == 1
        j = row % nb
        # the window of block j is rows j .. j + q - 1 of its own source
        assert windows[0] == list(range(j, j + q)) and windows[0][-1] < nb + q - 1


def test_launch_as_issue_floor_counts_the_real_outputs_alone():
    # 8 (q - 1) unfused operations an output and bin, S x nb outputs: the
    # q - 1 window starts between two sources add nothing
    for s_, nb, q, want in ((16, 256, 256, 0.128), (16, 256, 64, 0.032), (16, 64, 256, 0.032),
                            (16, 64, 64, 0.008), (1, 2048, 256, 0.064)):
        ms = bench.forward_issue_ms(s_, nb, 513, q)
        assert ms == s_ * nb * 513 * 8 * (q - 1) / bench.PEAK_FP32_ISSUE * 1e3
        assert round(ms, 3) == want
        assert bench.forward_issue_ms(2 * s_, nb, 513, q) == 2 * ms
    # the table's bound counts the same operations over the FMA rate, plus
    # the sub-block DFTs and the distance multiply
    fpb, q = 4, 256
    twiddles = bench.forward_flops(16, 256, fpb, 513, q) - 16 * (256 + q - 1) * 4 * fpb * 513
    assert twiddles == 16 * 256 * 513 * (8 * (q - 1) + 6)
    assert bench.PEAK_FP32_ISSUE * 2 == pytest.approx(bench.PEAK_FP32_FLOPS, rel=0.01)


def test_the_seam_refuses_a_ring_form_or_part_the_library_lacks():
    ops = bench.forward_operands(1, 4, "cpu", seed=0)
    with pytest.raises(ValueError, match="the ring form does not exist at fpb 128, pad 1024"):
        tfs._forward_cuda(*ops, form=tfs.FWD_RING, **GEO)
    for form, part, scratch in ((tfs.FWD_RING, tfs.PLANES_DFT, (None, None)),
                                (tfs.FWD_PLANES, "twiddles", (None, None)),
                                (tfs.FWD_PLANES, tfs.PLANES_SUM, None)):
        with pytest.raises(ValueError, match="the planes form's"):
            tfs._forward_cuda(*ops, form=form, part=part, scratch=scratch, **GEO)
    assert not any(tfs.forward_launches.values())
