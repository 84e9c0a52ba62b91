"""Launch B's split form past one t-tile and eight tail blocks: where it
exists, the layout each kernel takes, the form the wrappers pick at each
row count, and the card-side script that holds and times the form against
launch B (its operands built and run through the twins here; the form
itself runs on the card only, tests/test_torch_cuda.py -k split)."""

import importlib.util
from pathlib import Path

import pytest
import torch

from jefferson_tpu_torch.config import EngineConfig
from jefferson_tpu_torch.hrtf.kemar import synthetic_database
from jefferson_tpu_torch.kernels import fused_apply as tfa
from jefferson_tpu_torch.kernels import fused_spatializer as tsp
from jefferson_tpu_torch.kernels import fused_step as tfs
from jefferson_tpu_torch.scripts import split_layouts as sl


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("fpb,pad,split", [
    (2048, 4096, True), (128, 4096, True), (441, 1024, True),       # the form's new geometries
    (128, 1024, True), (1024, 2048, True), (100, 1024, True), (4, 1024, True),  # as before
    (2, 1024, False), (32, 64, False), (128, 8192, False), (64, 128, False),
])
def test_split_form_exists_to_sixteen_whole_blocks(fpb, pad, split):
    """Up to 16 whole 128-bin tail blocks; a row of fpb floats that is not
    whole float4 columns only past one t-tile (fpb > 128)."""
    assert tfs.geometry_forms(fpb, pad).split is split


def test_the_layout_each_kernel_takes():
    """Narrow for the kernels that blend their rows past one t-tile, else
    chunked (csrc/fused_forward.cuh launch_split_tail)."""
    blended = (tfs.GROUPED, "fused_step_stream_onehot_xfade",
               "fused_step_stream_onehot_grouped_xfade", tfs.SPATIALIZER)
    pre_blended = [k for k in sl.MAIN_ROWS if k not in blended]
    assert set(tfs.BLENDED) == set(blended) and len(pre_blended) == 6
    for fpb in (4, 64, 100, 128):
        assert {tfs.split_default(k, fpb) for k in sl.MAIN_ROWS} == {tfs.SPLIT_CHUNKED}
    for fpb in (256, 441, 1024, 2048):
        assert {tfs.split_default(k, fpb) for k in blended} == {tfs.SPLIT_NARROW}
        assert {tfs.split_default(k, fpb) for k in pre_blended} == {tfs.SPLIT_CHUNKED}


def test_launch_b_spans_are_measured_counts_where_the_split_form_exists():
    """Each span's ends are counts the script's crossover reads, at a
    geometry with the split form away from 128 / 1024, for a kind of row."""
    assert tfs.LAUNCH_B_SPANS
    for (fpb, pad), spans in tfs.LAUNCH_B_SPANS.items():
        assert tfs.geometry_forms(fpb, pad).split and (fpb, pad) != (128, 1024)
        for kind, (first, last) in spans.items():
            assert kind in ("blended", "pre-blended", "row 8")
            assert first <= last and {first, last} <= set(sl.CROSS_ROWS)


@pytest.mark.parametrize("geo,kind", [(g, k) for g, spans in tfs.LAUNCH_B_SPANS.items()
                                      for k in spans])
def test_pick_form_takes_launch_b_on_its_span_alone(geo, kind):
    """Launch B at both ends of the span and inside it, the split form just
    outside it, for every kernel of the kind."""
    first, last = tfs.LAUNCH_B_SPANS[geo][kind]
    kernels = (list(tfs.PRE_BLENDED) if kind == "pre-blended" else
               [k for k in tfs.BLENDED if (k == tfs.SPATIALIZER) == (kind == "row 8")])
    for k in kernels:
        pick = (lambda r: tsp.pick_form(r, *geo)) if k == tfs.SPATIALIZER else (
            lambda r: tfs.pick_form(k, r, *geo))
        assert {pick(first), pick(last), pick((first + last) // 2)} == {tfs.LAUNCH_B}, k
        assert pick(last + 1) == tfs.SPLIT, k
        if first > 1:
            assert pick(first - 1) == tfs.SPLIT, k


@pytest.mark.parametrize("name,rows,fpb,pad,want", [
    # rows 5-7 took less in the split form at every measured count
    ("fused_step_xfade", 512, 1024, 2048, tfs.SPLIT),
    ("fused_apply_xfade", 4096, 441, 1024, tfs.SPLIT),
    ("fused_step_stream_xfade", 2048, 256, 1024, tfs.SPLIT),
    # 128 / 1024 as before: the split form from one row
    ("fused_step_xfade/no_xfade", 1, 128, 1024, tfs.SPLIT),
    (tfs.GROUPED, 4096, 128, 1024, tfs.SPLIT),
    # rows 2-4 near launch B's whole wave, within the runs' spread at f256
    ("fused_step_stream_onehot_xfade", 2048, 256, 1024, tfs.SPLIT),
    ("fused_step_stream_onehot_grouped_xfade", 512, 1024, 2048, tfs.LAUNCH_B),
    ("fused_step_stream_onehot_grouped_xfade", 256, 1024, 2048, tfs.SPLIT),
    (tfs.GROUPED, 256, 2048, 4096, tfs.LAUNCH_B),
    (tfs.GROUPED, 4096, 2048, 4096, tfs.SPLIT),
    # no split form at fpb 2 (a ragged basis row at one t-tile): launch B
    ("fused_apply_xfade", 64, 2, 1024, tfs.LAUNCH_B),
    # row 1 never takes it
    (tfs.ROW1, 4096, 2048, 4096, tfs.LAUNCH_B),
])
def test_pick_form_at_named_counts(name, rows, fpb, pad, want):
    assert tfs.pick_form(name, rows, fpb, pad) == want


@pytest.mark.parametrize("rows,fpb,pad,want", [
    (1, 441, 1024, tsp.SPLIT), (1, 128, 1024, tsp.CLUSTER), (12556, 128, 1024, tsp.SPLIT),
    (16384, 2048, 4096, tsp.SPLIT), (1, 2, 1024, tsp.LAUNCH_B),
    # f441's render_scan chunk of 3,644 rows, inside launch B's span
    (3644, 441, 1024, tsp.LAUNCH_B), (6144, 441, 1024, tsp.SPLIT),
    # where the tile fits the block: launch B from 3,072 rows at fpb 64
    # (pad 512 and 1024) and 16, from 6,144 at fpb 4
    (4096, 64, 512, tsp.LAUNCH_B), (8192, 64, 1024, tsp.LAUNCH_B),
    (2048, 64, 1024, tsp.SPLIT), (4096, 4, 1024, tsp.SPLIT), (6144, 4, 1024, tsp.LAUNCH_B),
])
def test_row_8_pick_at_named_counts(rows, fpb, pad, want):
    assert tsp.pick_form(rows, fpb, pad) == want


@pytest.mark.parametrize("b,s,want", [
    ([1.0, 1.01], [1.2, 1.21], tfs.LAUNCH_B),
    ([1.3, 1.31], [1.0, 1.02], tfs.SPLIT),
    ([1.0, 1.3], [1.2, 1.21], sl.WITHIN),       # launch B's spread past the gap
    ([1.0, 1.02], [1.01, 1.03], sl.WITHIN),     # readings overlap
    ([1.0], [1.1], tfs.LAUNCH_B),
    ([1.0], [1.04], sl.WITHIN),                 # inside a reading's spread between runs
])
def test_a_count_goes_to_a_form_only_past_the_spread(b, s, want):
    assert sl.verdict(b, s) == want


_CFG = EngineConfig(frames_per_buffer=128, hrtf_len=512)


@pytest.fixture(scope="module")
def db128():
    return synthetic_database(_CFG)


@pytest.mark.parametrize("kernel", [k for k in sl.MAIN_ROWS if k != tfs.SPATIALIZER])
def test_split_layouts_steps_run_the_wrappers(db128, kernel):
    """The script's operands for each kernel of rows 2-7: on the CPU the
    wrapper in either form is its twin, at the shape asked for, and the
    bytes the bound counts cover the output."""
    call, twin, (s, nb), moved = sl.step(db128, kernel, 64, "cpu")
    assert s * nb == 64
    got = call(tfs.LAUNCH_B)
    assert got.shape == (64, 2 * _CFG.frames_per_buffer)
    assert torch.equal(got, call(tfs.SPLIT)) and torch.equal(got, twin())
    assert moved > got.numel() * 4


def test_split_layouts_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        sl.measure("f2048")


def test_tail_times_needs_a_card(monkeypatch):
    """scripts/tail_times.py (rows 1-8's device time alone at a checkout)
    raises without a card rather than time the twins."""
    from jefferson_tpu_torch.scripts import tail_times

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tail_times.main(["--geometry", "f64"])


def test_chip_smoke_times_every_kernel_where_the_tile_fits():
    """Where launch B's tile fits a block below 128 columns, phase geometry
    holds and times every kernel of rows 2-8 in both forms (split_timing),
    at each such geometry of its table."""
    smoke = _smoke()
    fitted = [g for g, (fpb, taps) in smoke.GEOMETRIES.items()
              if tfs.geometry_forms(fpb, EngineConfig(frames_per_buffer=fpb, hrtf_len=taps)
                                    .pad_len).tile_cols < tfs.T_TILE]
    assert sorted(fitted) == ["f16", "f4", "f64", "f64t256"]
    assert len(sl.MAIN_ROWS) == 10 and set(smoke.SPLIT_ROWS) < set(sl.MAIN_ROWS)


def test_chip_smoke_times_the_split_form_where_it_is_new():
    """Phase geometry times rows 5-8's split form at the geometries this
    form reaches first, with the script's (fpb, taps), and reads both forms
    at the ends of the spans that set a pick there."""
    smoke = _smoke()
    assert set(smoke.SPLIT_TIMED) <= set(smoke.GEOMETRIES) & set(sl.GEOMETRIES)
    assert all(smoke.GEOMETRIES[g] == sl.GEOMETRIES[g] for g in smoke.GEOMETRIES)
    for name in smoke.SPLIT_TIMED:
        fpb, taps = smoke.GEOMETRIES[name]
        cfg = EngineConfig(frames_per_buffer=fpb, hrtf_len=taps)
        assert tfs.geometry_forms(fpb, cfg.pad_len).split
    assert set(smoke.SPLIT_ROWS) == {"fused_step_stream_xfade", "fused_step_xfade",
                                     "fused_apply_xfade", tfs.SPATIALIZER} <= set(sl.MAIN_ROWS)
    assert tfa.NO_XFADE in sl.MAIN_ROWS
    for (fpb, pad), spans in tfs.LAUNCH_B_SPANS.items():
        if "row 8" in spans:
            assert smoke.split_cross(fpb, pad, tfs.SPATIALIZER) == tuple(sorted(
                set(spans["row 8"])))
    assert smoke.split_cross(2048, 4096, "fused_step_xfade") == ()
