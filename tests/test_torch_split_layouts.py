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
    """By the kind of row and the t-tiles of 128 columns (csrc/
    fused_forward.cuh split_layout): chunked at one t-tile; past it
    pipelined for blended rows, and for pre-blended rows chunked up to
    fifteen and pipelined from sixteen (fpb 2048)."""
    blended = (tfs.GROUPED, "fused_step_stream_onehot_xfade",
               "fused_step_stream_onehot_grouped_xfade", tfs.SPATIALIZER)
    pre_blended = [k for k in sl.MAIN_ROWS if k not in blended]
    assert set(tfs.BLENDED) == set(blended) and len(pre_blended) == 6
    for fpb in (4, 64, 100, 128):
        assert {tfs.split_default(k, fpb) for k in sl.MAIN_ROWS} == {tfs.SPLIT_CHUNKED}
    for fpb, want_b, want_p in ((129, tfs.SPLIT_PIPE, tfs.SPLIT_CHUNKED),
                                (256, tfs.SPLIT_PIPE, tfs.SPLIT_CHUNKED),
                                (441, tfs.SPLIT_PIPE, tfs.SPLIT_CHUNKED),
                                (896, tfs.SPLIT_PIPE, tfs.SPLIT_CHUNKED),
                                (1024, tfs.SPLIT_PIPE, tfs.SPLIT_CHUNKED),
                                (1920, tfs.SPLIT_PIPE, tfs.SPLIT_CHUNKED),
                                (1921, tfs.SPLIT_PIPE, tfs.SPLIT_PIPE),
                                (2048, tfs.SPLIT_PIPE, tfs.SPLIT_PIPE)):
        assert {tfs.split_default(k, fpb) for k in blended} == {want_b}, fpb
        assert {tfs.split_default(k, fpb) for k in pre_blended} == {want_p}, fpb


_HEADER = Path(__file__).resolve().parents[1] / "jefferson_tpu_torch" / "csrc" / "fused_forward.cuh"


def test_the_mirror_holds_the_headers_thresholds():
    """fused_step's threshold and layout codes are the header's constants
    (split_layout reads the one, jt_geometry reports the others)."""
    import re

    text = _HEADER.read_text()
    got = {k: int(v) for k, v in re.findall(r"constexpr int (PIPE_\w+_TILES) = (\d+);", text)}
    assert got == {"PIPE_PRE_BLENDED_TILES": tfs.PIPE_PRE_BLENDED_TILES}
    enum = re.search(r"enum SplitLayout \{([^}]*)\}", text)[1]
    codes = {k: int(v) for k, v in re.findall(r"LAYOUT_(\w+) = (\d+)", enum)}
    assert codes == {"NONE": tfs._LAYOUT_CODE[""], "CHUNKED": tfs._LAYOUT_CODE[tfs.SPLIT_CHUNKED],
                     "PIPE": tfs._LAYOUT_CODE[tfs.SPLIT_PIPE]}


@pytest.mark.parametrize("name", sorted(_smoke().GEOMETRIES))
def test_the_layouts_the_libraries_report_follow_the_headers_rule(name):
    """At every geometry of phase geometry, ``geometry_forms`` gives the
    layout the header's split_layout takes for each kind of row (the card
    holds each library's own report to it, ``jt_geometry`` out[11:13]):
    none without the split form, else by the t-tiles of 128 columns; phase
    geometry times the split form wherever a library takes the pipelined
    layout."""
    smoke = _smoke()
    fpb, taps = smoke.GEOMETRIES[name]
    forms = tfs.geometry_forms(fpb, EngineConfig(frames_per_buffer=fpb, hrtf_len=taps).pad_len)
    t_tiles = -(-fpb // tfs.T_TILE)
    if not forms.split:
        assert forms.layouts == ("", "")
        return
    want = (tfs.SPLIT_PIPE if t_tiles > 1 else tfs.SPLIT_CHUNKED,
            tfs.SPLIT_PIPE if t_tiles >= 16 else tfs.SPLIT_CHUNKED)
    assert forms.layouts == want
    assert forms.layouts[0] == tfs.split_default(tfs.SPATIALIZER, fpb)
    assert forms.layouts[1] == tfs.split_default("fused_apply_xfade", fpb)
    if tfs.SPLIT_PIPE in forms.layouts:
        assert name in smoke.SPLIT_TIMED


def test_launch_b_spans_are_measured_counts_where_the_split_form_exists():
    """Each span's ends are counts the script's crossover reads, at a
    geometry with the split form away from 128 / 1024, for a kind of row."""
    assert tfs.LAUNCH_B_SPANS
    for (fpb, pad), spans in tfs.LAUNCH_B_SPANS.items():
        assert tfs.geometry_forms(fpb, pad).split and (fpb, pad) != (128, 1024)
        for kind, (first, last) in spans.items():
            assert kind in ("blended", "pre-blended", "row 8")
            assert first <= last and {first, last} <= set(sl.CROSS_ROWS)


@pytest.mark.parametrize("geo,kind", [
    (g, k) for g, spans in tfs.LAUNCH_B_SPANS.items() for k in spans
    if g[0] > tfs.T_TILE and g[0] % tfs.T_TILE == 0])
def test_launch_b_keeps_one_whole_wave_past_one_t_tile(geo, kind):
    """Past one t-tile, at whole t-tiles, launch B keeps the one count
    where its grid of ceil(rows / 32) x T_TILES CTAs is one whole wave of
    128, for blended rows and row 8 alone; rows 5-7 take the split form
    at every count there."""
    t_tiles = geo[0] // tfs.T_TILE
    assert kind in ("blended", "row 8")
    assert tfs.LAUNCH_B_SPANS[geo][kind] == (128 * 32 // t_tiles,) * 2
    assert "pre-blended" not in tfs.LAUNCH_B_SPANS[geo]


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
    # f441: launch B's span 1,024-2,048 rows; the render_scan chunk of
    # 3,644 rows past it since the pipelined layout
    (2048, 441, 1024, tsp.LAUNCH_B), (3644, 441, 1024, tsp.SPLIT), (6144, 441, 1024, tsp.SPLIT),
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


def test_the_library_yardstick_is_one_matmul_of_the_tail_product():
    """tail_times.tail_product_ms times one torch.matmul of the rows' q
    planes ((sides * 2 * rows) x 2 bins) by the tail basis (2 bins x fpb),
    with TF32 off during the call and the caller's setting back after."""
    from jefferson_tpu_torch.scripts import tail_times

    seen = []

    def timer(call):
        seen.append((torch.backends.cuda.matmul.allow_tf32, tuple(call().shape)))
        return 0.25

    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        assert tail_times.tail_product_ms(3, 2, 9, 8, "cpu", timer) == 0.25
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert seen == [(False, (12, 8))]


def test_the_smoke_reads_the_occupancy_and_the_library_yardstick():
    """Phase geometry reads the occupancy of both render-step libraries and
    the library yardstick of rows 5-8 at geometries it runs."""
    from jefferson_tpu_torch.kernels import build
    from jefferson_tpu_torch.scripts import tail_times

    smoke = _smoke()
    assert {lib for lib, _, _ in smoke.SPLIT_OCCUPANCY} == set(build.GEOMETRIC)
    assert set(smoke.LIBRARY_TIMED) <= set(smoke.GEOMETRIES)
    assert set(tail_times.LIBRARY_ROWS) == set(smoke.SPLIT_ROWS)
