"""The probe kernels (rows 9-12) and the port's probe scripts: each plain
twin against the JAX script's Pallas kernel in interpret mode on the CPU,
the wrappers' checks, the host copies pinned to the originals, and the
error budget at a small size.

Tolerances, each from one cause:
- row 9: JAX on the CPU contracts ``a*b - c*d`` into an FMA, the twin
  rounds both products, so an element may differ by up to one rounding of
  the larger product: 2^-22 of the plane's two |products|;
- rows 10-11: fp32 contractions summed in other orders: 2e-6 of the
  output's peak;
- row 12: the same contraction in the Pallas body's ``w*rows`` + acc:
  2^-22 of the sum of the four |w_k T[i_k]|; the twin and the gathers
  (``xla16``) are bit-equal.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from jefferson_tpu import DEFAULT_CONFIG
from jefferson_tpu import testing as jtesting
from jefferson_tpu.engine import plan as jplan
from jefferson_tpu.hrtf import kemar as jkemar
from jefferson_tpu.ops import fft as jfft
from jefferson_tpu.trajectory.trajectory import CircularOrbit
from jefferson_tpu_torch import testing as ttesting
from jefferson_tpu_torch.engine import renderer as trenderer
from jefferson_tpu_torch.hrtf.kemar import synthetic_database
from jefferson_tpu_torch.kernels import assoc_probe as tap
from jefferson_tpu_torch.kernels import dma_blend as tdb
from jefferson_tpu_torch.kernels import fused_apply as tfa
from jefferson_tpu_torch.kernels import fused_step as tfs
from jefferson_tpu_torch.ops import fft as tops
from jefferson_tpu_torch.oracle.reference import render_oracle
from jefferson_tpu_torch.scripts import apply_assoc_probe as sap
from jefferson_tpu_torch.scripts import bench_blend_variants as sbb
from jefferson_tpu_torch.scripts import error_budget as seb

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ULP = 2.0**-22
MM_REL = 2e-6


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jap():
    return _script("apply_assoc_probe")


@pytest.fixture(scope="module")
def jbb():
    return _script("bench_blend_variants")


@pytest.fixture(scope="module")
def probe_inputs():
    return sap.inputs()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _f64(a):
    return np.asarray(a, np.float64)


# ---- the inputs and host copies -------------------------------------------

def test_probe_inputs_are_the_jax_scripts(jap, probe_inputs):
    rng = np.random.default_rng(0)
    b, bins = jap.B, jap.BINS
    xr = (rng.standard_normal((b, bins)) * 8).astype(np.float32)
    xi = (rng.standard_normal((b, bins)) * 8).astype(np.float32)
    dec = np.exp(-np.arange(bins) / 200.0).astype(np.float32)
    gr = (rng.standard_normal((b, bins)) * dec).astype(np.float32)
    gi = (rng.standard_normal((b, bins)) * dec).astype(np.float32)
    icr, ici = jfft._idft_tail_matrices(jap.N, jap.FPB)
    for got, want in zip(probe_inputs, (xr, xi, gr, gi, icr, ici)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (sap.B, sap.BINS, sap.FPB, sap.N) == (jap.B, jap.BINS, jap.FPB, jap.N)


@pytest.mark.parametrize("shape", [(7,), (3, 5), (0,)])
@pytest.mark.parametrize("eps", [1e-8, 1e-3])
def test_precision_check_is_the_jax_packages(shape, eps):
    rng = np.random.default_rng(len(shape))
    a = rng.standard_normal(shape).astype(np.float32)
    b = (a + rng.standard_normal(shape) * 1e-4).astype(np.float32)
    got, want = ttesting.precision_check(a, b, eps), jtesting.precision_check(a, b, eps)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert str(got) == str(want) and bool(got) == bool(want)
    with pytest.raises(ValueError, match="shape mismatch"):
        ttesting.precision_check(np.zeros(3), np.zeros(4))


def test_blend_workload_is_the_jax_scripts():
    r_rows, nb = 100, 32
    rows_i, rows_w = [], []
    for i in range(-(-r_rows // (nb + 1))):
        p = jplan.make_plan(CircularOrbit(period_s=0.4 + 0.01 * i, ele=5, r=1.0)
                            .sample(nb, DEFAULT_CONFIG), DEFAULT_CONFIG)
        rows_i.append(np.concatenate([p.idx_old[:1], p.idx_new]))
        rows_w.append(np.concatenate([p.w_old[:1], p.w_new]))
    idx, w = sbb.workload(r_rows)
    assert np.array_equal(idx, np.concatenate(rows_i)[:r_rows].astype(np.int32))
    assert np.array_equal(w, np.concatenate(rows_w)[:r_rows].astype(np.float32))


def test_pair_table_is_the_jax_scripts():
    """The successor and pair tables and pid0/pid2 as
    scripts/bench_blend_variants.py:167-183 builds them."""
    idx, _ = sbb.workload(264)
    table, _ = sbb.tables()
    succ = np.empty(jkemar.NUM_HRTF, np.int32)
    for e in range(jkemar.NUM_ELEV):
        o, n = jkemar.AZIMUTH_OFFSET[e], jkemar.AZIMUTH_COUNTS[e]
        succ[o : o + n] = o + (np.arange(n) + 1) % n
    pair = np.concatenate([np.concatenate([table, table[succ]], axis=1),
                           np.concatenate([table, table], axis=1)])
    same01, same23 = idx[:, 1] == idx[:, 0], idx[:, 3] == idx[:, 2]
    got = sbb.pair_operands(table, idx)
    assert np.array_equal(sbb.successor(), succ)
    assert np.array_equal(got[0], pair)
    assert np.array_equal(got[1], idx[:, 0] + jkemar.NUM_HRTF * same01)
    assert np.array_equal(got[2], idx[:, 2] + jkemar.NUM_HRTF * same23)
    bad = idx.copy()
    bad[0, 1] = succ[succ[bad[0, 0]]]
    with pytest.raises(ValueError, match="successor"):
        sbb.pair_operands(table, bad)


# ---- row 9 -------------------------------------------------------------------

def test_prod_twin_matches_prod_pallas(jap, probe_inputs):
    xr, xi, gr, gi = probe_inputs[:4]
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(a) for a in jap.prod_pallas(xr, xi, gr, gi)]
    got = [t.numpy() for t in tap.prod(*map(_t, (xr, xi, gr, gi)))]
    scales = (np.abs(_f64(xr * gr)) + np.abs(_f64(xi * gi)),
              np.abs(_f64(xr * gi)) + np.abs(_f64(xi * gr)))
    for g, w, sc in zip(got, want, scales):
        assert g.shape == w.shape == (sap.B, sap.BINS) and g.dtype == np.float32
        assert np.all(np.abs(_f64(g) - w) <= ULP * sc)
    # the twin rounds each product on its own: numpy's order, bit for bit
    assert np.array_equal(got[0], xr * gr - xi * gi) and np.array_equal(got[1], xr * gi + xi * gr)


def test_contracted_forms_name_the_jax_contraction(jap, probe_inputs):
    """The probe's float64 stand-in for an FMA reproduces XLA's CPU
    contraction of qr bit for bit."""
    xr, xi, gr, gi = probe_inputs[:4]
    with pltpu.force_tpu_interpret_mode():
        qr = np.asarray(jap.prod_pallas(xr, xi, gr, gi)[0])
    keeps_ab, _ = sap.contracted(xr, gr, xi, gi, -1.0)
    assert np.array_equal(qr, keeps_ab)


# ---- rows 10 and 11 ------------------------------------------------------------

@pytest.fixture(scope="module")
def q_planes(probe_inputs):
    xr, xi, gr, gi = probe_inputs[:4]
    return xr * gr - xi * gi, xr * gi + xi * gr


def test_mm_twin_matches_mm_pallas(jap, probe_inputs, q_planes):
    icr, ici = probe_inputs[4:]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jap.mm_pallas(*q_planes, icr, ici))
    got = tap.mm(*map(_t, (*q_planes, icr, ici))).numpy()
    assert got.shape == want.shape == (sap.B, sap.FPB)
    assert np.abs(_f64(got) - want).max() <= MM_REL * np.abs(want).max()


@pytest.mark.parametrize("chunks", [2, 4, 8])
def test_mm_tree_twin_matches_mm_pallas_tree(jap, probe_inputs, q_planes, chunks):
    k5 = sap.BINS - 1
    ops = [np.ascontiguousarray(q[:, :k5]) for q in q_planes] + \
          [np.ascontiguousarray(b[:k5]) for b in probe_inputs[4:]]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jap.mm_pallas_tree(*ops, chunks))
    got = tap.mm_tree(*map(_t, ops), chunks).numpy()
    assert np.abs(_f64(got) - want).max() <= MM_REL * np.abs(want).max()


def test_mm_tree_with_one_chunk_is_mm(probe_inputs, q_planes):
    ops = tuple(map(_t, (*q_planes, *probe_inputs[4:])))
    assert torch.equal(tap.mm_tree(*ops, 1), tap.mm(*ops))


@pytest.mark.parametrize("n,want", [
    (1, "0"), (2, "(0+1)"), (3, "((0+1)+2)"), (5, "(((0+1)+(2+3))+4)"),
    (7, "(((0+1)+(2+3))+((4+5)+6))"),
])
def test_tree_sums_pairwise_and_carries_the_odd_part(n, want):
    class Term(str):
        def __add__(self, other):
            return Term(f"({self}+{other})")

    assert tap.tree([Term(i) for i in range(n)]) == want


@pytest.mark.parametrize("k,chunks", [(513, 2), (512, 3), (512, 0), (512, 32)])
def test_mm_tree_refuses_chunks_that_do_not_cut_k(k, chunks):
    """The TPU body would drop the last k % chunks columns without a word."""
    rng = np.random.default_rng(1)
    q = _t(rng.standard_normal((8, k)).astype(np.float32))
    b = _t(rng.standard_normal((k, 16)).astype(np.float32))
    with pytest.raises(ValueError, match="chunks"):
        tap.mm_tree(q, q, b, b, chunks)
    with pytest.raises(ValueError, match="chunks"):
        tap.mm_tree_reference(q, q, b, b, chunks)


def test_probe_wrappers_refuse_operands_they_do_not_take(probe_inputs, q_planes):
    xr, xi, gr, gi, icr, ici = map(_t, probe_inputs)
    with pytest.raises(ValueError, match="gi: want contiguous"):
        tap.prod(xr, xi, gr, gi.double())
    with pytest.raises(ValueError, match="gr: want contiguous"):
        tap.prod(xr, xi, gr[:, :7], gi)
    qr, qi = map(_t, q_planes)
    with pytest.raises(ValueError, match="icr: want contiguous"):
        tap.mm(qr, qi, icr.t().contiguous().t(), ici)
    with pytest.raises(ValueError, match="ici: want contiguous"):
        tap.mm(qr, qi, icr, ici[:512])
    with pytest.raises(ValueError, match="2-D"):
        tap.mm(qr[0], qi[0], icr, ici)


def test_cpu_calls_are_not_counted(probe_inputs):
    tfs.reset_launches()
    ops = tuple(map(_t, probe_inputs))
    tap.prod(*ops[:4])
    tap.mm(ops[0], ops[1], ops[4], ops[5])
    assert not any(tfs.launches.values())


# ---- row 12 -------------------------------------------------------------------

def _blend_case(r=64, seed=3):
    rng = np.random.default_rng(seed)
    table, table_pad = sbb.tables()
    idx = rng.integers(0, jkemar.NUM_HRTF, (r, 4)).astype(np.int32)
    w = rng.random((r, 4)).astype(np.float32)
    return table, table_pad, idx, w


def test_dma_blend_twin_matches_pallas_dma_blend(jbb):
    table, table_pad, idx, w = _blend_case()
    c_pad = table_pad.shape[1]
    want = np.asarray(jbb.pallas_dma_blend(jnp.asarray(table_pad.reshape(-1)), jnp.asarray(idx),
                                           jnp.asarray(w), c_pad, tb=16, interpret=True))
    got = tdb.dma_blend(_t(table_pad.reshape(-1)), _t(idx), _t(w), c_pad, tb=16).numpy()
    assert got.shape == want.shape == (64, c_pad)
    scale = sum(np.abs(_f64(w[:, k : k + 1]) * table_pad[idx[:, k]]) for k in range(4))
    assert np.all(np.abs(_f64(got) - want) <= ULP * scale)
    # the twin and the gathers are one computation, bit for bit
    bins = sap.BINS
    planes = tuple(jnp.asarray(table[:, j * bins : (j + 1) * bins]) for j in range(4))
    xla16 = np.asarray(jbb.xla16(planes, jnp.asarray(idx), jnp.asarray(w)))
    assert np.array_equal(got[:, : table.shape[1]].view(np.int32), xla16.view(np.int32))


def test_torch_blend_variants_are_bit_equal():
    idx, w = sbb.workload(264)
    table, table_pad = sbb.tables()
    c, bins = table.shape[1], sap.BINS
    pair, pid0, pid2 = sbb.pair_operands(table, idx)
    planes = tuple(_t(table[:, j * bins : (j + 1) * bins]) for j in range(4))
    outs = [
        sbb.xla16(planes, _t(idx), _t(w)),
        sbb.xla4(_t(table), _t(idx), _t(w)),
        sbb.xla2pair(_t(pair), _t(pid0), _t(pid2), _t(w), c),
        tdb.dma_blend(_t(table_pad.reshape(-1)), _t(idx), _t(w), table_pad.shape[1], tb=8)[:, :c],
    ]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_dma_blend_ids_outside_the_table_contribute_nothing():
    _, table_pad, idx, w = _blend_case(r=16)
    c_pad = table_pad.shape[1]
    idx[3, 1], idx[5, 0], idx[9, 3] = jkemar.NUM_HRTF + 2, -4, jkemar.NUM_HRTF
    got = tdb.dma_blend(_t(table_pad.reshape(-1)), _t(idx), _t(w), c_pad, tb=8).numpy()
    ok = (idx >= 0) & (idx < jkemar.NUM_HRTF)
    ids, ws = np.where(ok, idx, 0), np.where(ok, w, np.float32(0))
    want = ws[:, 0:1] * table_pad[ids[:, 0]]
    for k in range(1, 4):
        want = want + ws[:, k : k + 1] * table_pad[ids[:, k]]
    assert np.array_equal(got, want)


def test_dma_blend_refuses_operands_it_does_not_take():
    _, table_pad, idx, w = _blend_case(r=32)
    flat, c_pad = _t(table_pad.reshape(-1)), table_pad.shape[1]
    idx_t, w_t = _t(idx), _t(w)
    with pytest.raises(ValueError, match="multiple of tb"):
        tdb.dma_blend(flat, idx_t, w_t, c_pad, tb=24)
    with pytest.raises(ValueError, match="multiple of 128"):
        tdb.dma_blend(flat, idx_t, w_t, 2052)
    with pytest.raises(ValueError, match="whole rows"):
        tdb.dma_blend(flat[:-128], idx_t, w_t, c_pad, tb=8)
    with pytest.raises(ValueError, match="idx: want contiguous"):
        tdb.dma_blend(flat, idx_t.long(), w_t, c_pad, tb=8)
    with pytest.raises(ValueError, match="w: want contiguous"):
        tdb.dma_blend(flat, idx_t, w_t.t().contiguous().t(), c_pad, tb=8)
    with pytest.raises(ValueError, match="w: want contiguous"):
        tdb.dma_blend(flat, idx_t, w_t[:, :3].contiguous(), c_pad, tb=8)
    with pytest.raises(ValueError, match="table_flat: want contiguous"):
        tdb.dma_blend(flat.double(), idx_t, w_t, c_pad, tb=8)
    with pytest.raises(ValueError, match="flat table"):
        tdb.dma_blend(flat.view(-1, c_pad), idx_t, w_t, c_pad, tb=8)


# ---- the scripts ----------------------------------------------------------------

def test_assoc_probe_script_runs_on_the_cpu(capsys):
    res = sap.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("\n") == 17 and out.startswith("A  product torch")
    assert res["A"]["bits_differ"] == [0, 0] and res["B"]["bits_differ"] == 0
    assert res["A"]["kernel_equals"]["qr"]["both rounded"] == sap.B * sap.BINS
    assert sorted(res["D"]["tree"]) == [2, 4, 8]
    for stage in "BCE":
        assert res[stage]["err_kernel"] < 1e-6
    # on the CPU each wrapper is its twin
    twins = res["twins"]
    assert twins["prod"] == {"max_abs": 0.0, "of_scale": 0.0}
    assert [t["k"] for t in twins["mm"]] == [513, 512]
    assert [t["chunks"] for t in twins["mm_tree"]] == [2, 4, 8]
    for t in twins["mm"] + twins["mm_tree"]:
        assert t["max_abs"] == 0.0 and t["finite"] and 0.5 < t["peak"] < 2.0


def test_blend_script_runs_on_the_cpu():
    res = sbb.main(["66", "6", "--device", "cpu"])
    assert res["rows"] == 66 and res["c_pad"] == 2176 and res["bound_ms"] is None
    assert set(res["variants"]) == {"xla16", "xla4", "xla2pair", "kernel"}
    for v in res["variants"].values():
        assert v["ms"] is None and v["bit_identical_to_xla16"]
    assert res["kernel_vs_twin"] == {"max_abs": 0.0, "bit_identical": True}


def test_blend_work_counts_the_named_rows_once():
    idx = np.array([[0, 1, 1, 0], [2, 2, 0, 1]], np.int32)
    flops, moved = sbb.work(idx, 128)
    assert flops == 7.0 * 2 * 128
    # two output rows, three named table rows, ids and weights
    assert moved == (2 + 3) * 128 * 4 + 2 * 8 * 4


def test_error_budget_refuses_an_hrtf_dir(tmp_path):
    """--hrtf-dir loads through hrtf.kemar.load_database, which refuses a
    directory that holds no database."""
    with pytest.raises(FileNotFoundError, match="no HRTF database"):
        seb.main(["--device", "cpu", "--hrtf-dir", str(tmp_path / "kemar")])


def test_error_budget_loads_an_hrtf_dir(tmp_path, monkeypatch):
    """--hrtf-dir runs the budget on the database in the tree: a compact
    tree written from the synthetic set loads bit-equal to a direct load."""
    from jefferson_tpu_torch.bench import write_compact_tree
    from jefferson_tpu_torch.hrtf.kemar import load_compact

    root = write_compact_tree(synthetic_database(), tmp_path / "compact")
    seen = {}
    monkeypatch.setattr(seb, "render_oracle", lambda *a, **k: None)
    monkeypatch.setattr(seb, "run", lambda db, *a: seen.setdefault("db", db) and {})
    seb.main(["--device", "cpu", "--hrtf-dir", str(root), "--blocks", "2", "--steps", "1"])
    want = load_compact(root)
    np.testing.assert_array_equal(seen["db"].hrirs, want.hrirs)
    np.testing.assert_array_equal(seen["db"].spectra, want.spectra)
    assert seen["db"].source == f"compact:{root}"


@pytest.fixture(scope="module")
def budget_case():
    db = synthetic_database()
    pos = seb.scenario(4, 3)
    signal = seb.noise()
    want = render_oracle(signal, db, [tuple(p) for p in pos], db.config, initial_old=(0.0, 0.0))
    return db, signal, pos, want


def test_error_budget_at_a_small_size(budget_case, monkeypatch):
    calls = []
    twin = tfa.fused_apply_xfade_reference

    def spy(*a, **k):
        calls.append(k.get("with_xfade", True))
        return twin(*a, **k)

    monkeypatch.setattr(tfa, "fused_apply_xfade_reference", spy)
    res = seb.run(*budget_case, torch.device("cpu"))
    for name in ("unfused", "apply_kernel", "fused"):
        assert res[name]["max_abs"] <= 1e-6
        assert res[name]["jax_margin"] == seb.JAX_MARGIN[name]
        assert res[name]["launches"] == {}
    assert res["unfused"]["dispatch"][0].startswith("dedup/")
    assert res["apply_kernel"]["dispatch"] == res["fused"]["dispatch"]
    # the apply-only twin ran once per chunk of the apply_kernel render only
    assert calls == [True]
    for name in ("unfused", "apply_kernel", "fused"):
        assert res[name]["jax_cpu_margin"] == seb.JAX_CPU_MARGIN[name]
    assert set(res["lane512"]) == set(res["tail_tree"]) == {"absent", "jax_margin",
                                                             "jax_cpu_margin"}
    assert res["signal"]["castanets"].startswith("absent")
    assert res["blend_micro_ab"]["max_abs"] <= 1e-6 * max(1.0, res["blend_micro_ab"]["table_peak"])
    assert trenderer._apply_maybe_full_fuse is not seb._apply_only


def test_error_budget_restores_the_renderer_when_a_render_raises(budget_case, monkeypatch):
    orig = (trenderer._apply_maybe_full_fuse, trenderer.dedup_distance)

    def boom(*a, **k):
        raise RuntimeError("apply failed")

    monkeypatch.setattr(tfa, "fused_apply_xfade_reference", boom)
    with pytest.raises(RuntimeError, match="apply failed"):
        seb.run(*budget_case, torch.device("cpu"))
    assert (trenderer._apply_maybe_full_fuse, trenderer.dedup_distance) == orig


def test_error_budget_swaps_one_stage_of_the_unfused_chain(budget_case):
    """The swaps run the unfused chain within the oracle gate and the
    swapped functions are restored.  On the CPU the forward swap changes no
    bit (the forward runs there anyway); the one-product tail may round
    otherwise than the blocked one.  The tail's two forms report a warm
    render's time."""
    res = seb.run(*budget_case, torch.device("cpu"))
    for name in seb.SWAPS:
        assert res[name]["max_abs"] <= 1e-6
        assert res[name]["dispatch"] == res["unfused"]["dispatch"]
        assert res[name]["jax_cpu_margin"] == seb.JAX_CPU_MARGIN["unfused"]
    assert res["unfused/forward_cpu"]["max_abs"] == res["unfused"]["max_abs"]
    assert {name for name in res if "render_ms" in res[name]} == {
        "unfused", "unfused/tail_one_product"}
    assert tops.irfft_tail is not tops.irfft_tail_split
    assert tops.rfft_sliding_split is not seb._forward_on_cpu


def test_error_budget_sums_the_side_pass_tail_by_blocks(monkeypatch):
    """fused/sidepass_blocked renders the fused dispatch with the sparse
    side-pass's old-side tail through ops/fft.irfft_tail (the 128-bin
    blocks), within the oracle gate, and puts irfft_tail_split back.  At 64
    blocks a position the sweep's crossfades are sparse: the side-pass
    runs."""
    db = synthetic_database()
    pos = seb.scenario(64, 3)
    signal = seb.noise()
    want = render_oracle(signal, db, [tuple(p) for p in pos], db.config, initial_old=(0.0, 0.0))
    tails = []
    blocked = tops.irfft_tail

    def spy(*a, **k):
        tails.append(a[0].shape)
        return blocked(*a, **k)

    monkeypatch.setattr(tops, "irfft_tail", spy)
    one_product = tops.irfft_tail_split
    res = seb.run(db, signal, pos, want, torch.device("cpu"))
    got = res["fused/sidepass_blocked"]
    assert got["max_abs"] <= 1e-6
    assert got["dispatch"] == res["fused"]["dispatch"]
    assert got["dispatch"] == ["dedup_fused/False/8"]
    # the unfused chains' tails (4 planes of every row), then the side-pass's
    # (2 ears of its 8-row bucket)
    assert (2, 8, db.config.num_bins) in tails and (4, len(pos), db.config.num_bins) in tails
    assert got["jax_margin"] == seb.JAX_MARGIN["fused"]
    assert tops.irfft_tail_split is one_product
    with seb.sidepass_blocked():
        assert tops.irfft_tail_split is spy
    assert tops.irfft_tail_split is one_product


@pytest.mark.parametrize("rows,bins", [(3, 513), (5, 130), (2, 100)])
def test_blocked_tail_is_the_tail_idft_by_blocks(rows, bins):
    """Five (or fewer) K-block products added in order: the tail IDFT's
    function, summed in another order (fp32, within 1e-6 of its peak)."""
    rng = np.random.default_rng(3)
    re, im = (torch.from_numpy(rng.standard_normal((2, rows, bins)).astype(np.float32))
              for _ in range(2))
    n = 2 * (bins - 1)
    got = tops.irfft_tail(re, im, n, 128)
    want = tops.irfft_tail_split(re, im, n, 128)
    assert got.shape == want.shape == (2, rows, 128)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
