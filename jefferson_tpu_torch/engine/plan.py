"""Host-side render plan: per-block positions -> gather indices and weights.

A copy of the parts of ``jefferson_tpu/engine/plan.py`` that the port's
renderers use, over the port's own copies of the host modules: NumPy, with
the plan core (nearest filter, interpolation set-up, distance split) and
the playhead stream in the port's host library (``native/``), as the JAX
package runs them in its native extension.  ``tests/test_torch_plan.py``
pins every function bit-for-bit to its JAX-package counterpart.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import native
from ..config import DEFAULT_CONFIG, EngineConfig
from ..hrtf.kemar import pick_hrtf, round_half_away
from ..ops.filters import distance_phase_split
from ..trajectory.interpolation import interpolation_calculations
from ..trajectory.spatial import radius_from_cartesian, spherical_to_cartesian

_F32 = np.float32


@dataclasses.dataclass
class RenderPlan:
    """Everything the device step needs, for B blocks."""

    num_blocks: int
    azi: np.ndarray          # (B,) float32, rounded degrees
    ele: np.ndarray          # (B,) float32, rounded degrees
    radii: np.ndarray        # (B,) float32, |coords| (unscaled)
    idx_new: np.ndarray      # (B, 4) int32
    w_new: np.ndarray        # (B, 4) float32
    idx_old: np.ndarray      # (B, 4) int32
    w_old: np.ndarray        # (B, 4) float32
    xfade: np.ndarray        # (B,) bool
    nearest: np.ndarray      # (B,) int32 — pick_hrtf per block (basic/TD paths)
    u_hi: np.ndarray         # (B,) float32 — distance phase split
    u_lo: np.ndarray         # (B,) float32
    inv_frac: np.ndarray     # (B,) float32


def make_plan(
    positions: np.ndarray,
    config: EngineConfig = DEFAULT_CONFIG,
    initial_old: tuple[float, float] | None = (0.0, 0.0),
) -> RenderPlan:
    """Build a plan from per-block spherical positions.

    positions: (B, 3) array-like of (azi_deg, ele_deg, r) — pre-rounding, the
    plan applies the reference's updateFromSpherical semantics
    (reference: Jefferson/src/SoundSource.cu:41-54).
    initial_old: crossfade state before block 0; (0, 0) mirrors the reference
    constructor (reference: Jefferson/src/SoundSource.cu:11-15); None seeds it
    with block 0's position so a static render never crossfades.
    """
    pos = np.asarray(positions, dtype=np.float64)
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(f"positions must be (B, 3) of (azi, ele, r), got {pos.shape}")
    b = pos.shape[0]
    if b == 0:
        raise ValueError("positions must contain at least one block")
    azi = round_half_away(pos[:, 0].astype(_F32)).astype(_F32)
    ele = round_half_away(pos[:, 1].astype(_F32)).astype(_F32)
    r_in = pos[:, 2].astype(_F32)
    coords = spherical_to_cartesian(azi, ele, r_in)
    radii = radius_from_cartesian(coords)

    if initial_old is None:
        old0_azi, old0_ele = azi[0], ele[0]
    else:
        old0_azi = _F32(round_half_away(_F32(initial_old[0])))
        old0_ele = _F32(round_half_away(_F32(initial_old[1])))
    old_azi = np.concatenate([[old0_azi], azi[:-1]]).astype(_F32)
    old_ele = np.concatenate([[old0_ele], ele[:-1]]).astype(_F32)
    xfade = (old_azi != azi) | (old_ele != ele)

    cn = interpolation_calculations(ele, azi)
    # old rows = [initial_old] + new rows shifted by one, computed AS that
    # shift, so the step's invariant 'old-position arrays equal the
    # previous block's new arrays' holds by construction
    c0 = interpolation_calculations(
        np.asarray([old0_ele], _F32), np.asarray([old0_azi], _F32)
    )
    idx_old = np.concatenate([c0.indices, cn.indices[:-1]]).astype(np.int32)
    w_old = np.concatenate([c0.weights, cn.weights[:-1]]).astype(_F32)
    nearest = pick_hrtf(ele, azi).astype(np.int32)

    scaled_r = (radii / _F32(config.distance_scale)).astype(_F32)
    u_hi, u_lo, inv_frac = distance_phase_split(config.fsvs, scaled_r, config.num_bins)

    return RenderPlan(
        num_blocks=b,
        azi=azi,
        ele=ele,
        radii=radii,
        idx_new=cn.indices.astype(np.int32),
        w_new=cn.weights,
        idx_old=idx_old,
        w_old=w_old,
        xfade=xfade,
        nearest=nearest,
        u_hi=u_hi,
        u_lo=u_lo,
        inv_frac=inv_frac,
    )


def pad_plan(p: RenderPlan, pad_b: int) -> RenderPlan:
    """Extend a plan by ``pad_b`` blocks repeating the final position with
    xfade=False.  The padded region's old rows are the last real block's
    NEW row, so the step's roll invariant (old[b+1] == new[b]) holds across
    the pad boundary; callers trim the padded output."""
    if pad_b <= 0:
        return p
    rep = lambda a: np.concatenate([a, np.repeat(a[-1:], pad_b, axis=0)])
    return dataclasses.replace(
        p,
        num_blocks=p.num_blocks + pad_b,
        azi=rep(p.azi), ele=rep(p.ele), radii=rep(p.radii),
        idx_new=rep(p.idx_new), w_new=rep(p.w_new),
        idx_old=np.concatenate([p.idx_old, np.repeat(p.idx_new[-1:], pad_b, 0)]),
        w_old=np.concatenate([p.w_old, np.repeat(p.w_new[-1:], pad_b, 0)]),
        xfade=np.concatenate([p.xfade, np.zeros(pad_b, bool)]),
        nearest=rep(p.nearest),
        u_hi=rep(p.u_hi), u_lo=rep(p.u_lo), inv_frac=rep(p.inv_frac),
    )


def dedup_rows(idx: np.ndarray, w: np.ndarray):
    """Unique (indices, weights) rows -> (uniq_idx, uniq_w, inverse).

    Keys are the raw bit patterns (int32 indices + float32 weight bits), so
    deduplication is exact.  The single-source Renderer blends only the
    unique rows of a chunk; the batched renderer uses it to decide, as the
    JAX BatchRenderer does, whether a render is a hold scene.
    """
    idx = np.asarray(idx, dtype=np.int32)
    w = np.asarray(w, dtype=np.float32)
    key = np.concatenate([idx, w.view(np.int32)], axis=1)
    uniq, inverse = np.unique(key, axis=0, return_inverse=True)
    k = idx.shape[1]
    return (
        np.ascontiguousarray(uniq[:, :k], dtype=np.int32),
        np.ascontiguousarray(uniq[:, k:]).view(np.float32),
        inverse.astype(np.int32).reshape(-1),
    )


def _compact_table(ids: np.ndarray, u_pad: int, what: str):
    """Unique ids padded to ``u_pad`` (repeat-last) + a remap LUT."""
    uniq = np.unique(ids)
    if len(uniq) > u_pad:
        raise ValueError(f"{what}: {len(uniq)} unique filters exceed the bucket {u_pad}")
    lut = np.zeros(int(ids.max()) + 1, np.int32)
    lut[uniq] = np.arange(len(uniq), dtype=np.int32)
    pad = np.concatenate([uniq, np.repeat(uniq[-1:], u_pad - len(uniq))]).astype(np.int32)
    return pad, lut


def compact_filter_ids(idx_old: np.ndarray, idx_last: np.ndarray, u_pad: int | None = None):
    """Unique filter ids + remapped bracket indices for the one-hot step.

    A chunk of real trajectories touches only a small subset of the 710
    filters (the bench workload: 68), so the blend runs against a compact
    table.  Returns (uniq_ids (U_pad,) padded to a power of two, ridx like
    idx_old, ridx_last like idx_last, U_pad).  ``u_pad``: an optional
    render-wide bucket, so every chunk's table has one shape.
    """
    idx_old = np.asarray(idx_old, np.int32)
    idx_last = np.asarray(idx_last, np.int32)
    all_ids = np.concatenate([idx_old.reshape(-1), idx_last.reshape(-1)])
    if u_pad is None:
        u_pad = max(8, 1 << int(np.ceil(np.log2(len(np.unique(all_ids))))))
    uniq_pad, lut = _compact_table(all_ids, u_pad, "chunk")
    return uniq_pad, lut[idx_old], lut[idx_last], u_pad


def compact_filter_ids_grouped(
    idx_old: np.ndarray, idx_last: np.ndarray, group: int, tb: int, u_pad: int
):
    """Per-group compact tables for the grouped one-hot step (wide movers).

    The chunk's blocks split into groups of ``group`` blocks, each with its
    own compact table of ``u_pad`` rows; the step blends tile i against the
    table of group i // (group // tb).  idx_old: (B, 4) OLD-aligned rows;
    idx_last: (1, 4) the chunk's final new row; ``tb``: the step's tile
    (boundary rows are per tile).

    Returns (uniq_ids (G*u_pad,), ridx (B, 4), rbnd (B/tb, 4)), all remapped
    into the owning group's table (each group's table includes its
    boundary rows' filters: the next tile's first old row, and idx_last for
    the chunk's final tile).
    """
    idx_old = np.asarray(idx_old, np.int32)
    idx_last = np.asarray(idx_last, np.int32)
    b = idx_old.shape[0]
    assert b % group == 0 and group % tb == 0
    n_tiles = b // tb
    tables, ridx = [], np.empty_like(idx_old)
    rbnd = np.empty((n_tiles, 4), np.int32)
    for g, start in enumerate(range(0, b, group)):
        stop = start + group
        bnds = np.concatenate(
            [idx_old[start + tb : stop : tb], idx_old[stop : stop + 1]]
            if stop < b
            else [idx_old[start + tb : stop : tb], idx_last]
        )
        ids = np.concatenate([idx_old[start:stop].reshape(-1), bnds.reshape(-1)])
        table, lut = _compact_table(ids, u_pad, f"group {g}")
        tables.append(table)
        ridx[start:stop] = lut[idx_old[start:stop]]
        rbnd[start // tb : stop // tb] = lut[bnds]
    return np.concatenate(tables), ridx, rbnd


def compact_filter_ids_grouped_sources(
    idx_old: np.ndarray, idx_last: np.ndarray, group_sources: int, u_pad: int
):
    """Per-source-group compact tables for the batched one-hot step (wide
    scenes): groups of ``group_sources`` consecutive sources share a table
    of ``u_pad`` rows.  Each source's boundary row is its own final new row,
    so no boundary crosses a group.

    idx_old: (S, nb, 4); idx_last: (S, 4).  Returns (uniq_ids (G*u_pad,),
    ridx (S, nb, 4), rlast (S, 4)), ids remapped into their group's table.
    """
    idx_old = np.asarray(idx_old, np.int32)
    idx_last = np.asarray(idx_last, np.int32)
    s = idx_old.shape[0]
    if s % group_sources:
        raise ValueError(f"{s} sources do not split into groups of {group_sources}")
    tables = []
    ridx = np.empty_like(idx_old)
    rlast = np.empty_like(idx_last)
    for g, start in enumerate(range(0, s, group_sources)):
        stop = start + group_sources
        ids = np.concatenate([idx_old[start:stop].reshape(-1), idx_last[start:stop].reshape(-1)])
        table, lut = _compact_table(ids, u_pad, f"group {g}")
        tables.append(table)
        ridx[start:stop] = lut[idx_old[start:stop]]
        rlast[start:stop] = lut[idx_last[start:stop]]
    return np.concatenate(tables), ridx, rlast


def _fed(signal, num_blocks: int, config: EngineConfig, repeat) -> np.ndarray:
    signal = np.asarray(signal, dtype=_F32)
    if signal.ndim != 1:
        raise ValueError("signal must be mono (1-D)")
    if len(signal) == 0:
        raise ValueError("empty signal")
    total = num_blocks * config.frames_per_buffer
    if len(signal) >= total:
        return signal[:total]
    return repeat(signal, num_blocks, config.frames_per_buffer)


def fed_stream(signal: np.ndarray, num_blocks: int, config: EngineConfig = DEFAULT_CONFIG) -> np.ndarray:
    """The sample stream the engine consumes: the input repeated (wrapping
    playhead, reference: Jefferson/src/Audio.cu:121-139) and truncated to
    num_blocks * frames_per_buffer samples; the repeat runs in the port's
    host library."""
    return _fed(signal, num_blocks, config, native.fed_stream)


def _fed_stream_numpy(signal: np.ndarray, num_blocks: int,
                      config: EngineConfig = DEFAULT_CONFIG) -> np.ndarray:
    """The plain form of ``fed_stream``: the repeat as ``np.tile``."""
    return _fed(signal, num_blocks, config,
                lambda s, nb, fpb: np.tile(s, -(-nb * fpb // len(s)))[: nb * fpb])
