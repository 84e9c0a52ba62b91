"""Multi-source batched rendering, on one device or sharded over a mesh.

Counterpart of ``jefferson_tpu/engine/batch.py``: the chunk functions of
every arm the JAX ``BatchRenderer`` dispatches to (the unfused chain and
its deduplicated form; the one-hot step with one shared or
per-source-group compact tables; the gather step, with the apply-only step
for tiles that do not own whole sources; the dedup+fused composition with
its no-crossfade and sparse-crossfade forms), the render-wide planning that
chooses among them, and ``BatchRenderer``, whose ``mesh`` shards the source
axis over ranks.  Sources are a leading batch axis; after the forward
transform, sources x blocks are independent rows of one tall matrix.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import EngineConfig
from ..convert import spectra_from_numpy
from ..hrtf.kemar import HRTFDatabase
from ..kernels import fused_step
from ..kernels.dma_blend import blend_rows
from ..kernels.fused_apply import fused_apply_xfade
from ..ops import fft as fft_ops
from ..ops.filters import cmul, distance_factors_split
from ..parallel.mesh import check_mesh, gather_rows, mix_all_reduce, source_range
from .plan import (
    compact_filter_ids, compact_filter_ids_grouped_sources, dedup_rows, fed_stream, make_plan,
    pad_plan,
)
from .renderer import (
    ChunkFetch, _apply_xfade_amortization, _fd_complex_chunk, _pad_cf_indices, _sparse_bucket,
    _sparse_xfade_fix, apply_filters_core, blend_cat, blend_channels, cat_table,
    check_card_geometry, dedup_distance, pick_fused_tile, resolve_device, split_planes,
)


def batched_chunk_fn(config: EngineConfig, num_blocks: int, with_xfade: bool = True):
    """Source-batched interpolating FD chunk (the unfused chain).

    Signature of the returned function:
      (spectra=(hr, hi), hists (S, hist), feds (S, nb*fpb),
       idx_new (S, nb, 4), w_new, idx_old, w_old, xfade (S, nb),
       u_hi, u_lo, inv_frac (S, nb))
      -> (outs (S, nb, fpb, 2), new_hists (S, hist))
    """
    fpb = config.frames_per_buffer
    if config.history_len % fpb:
        # non-aligned geometry: no shared sliding DFT, one chunk per source
        def fn_per_source(spectra, hists, *per_source):
            parts = [
                _fd_complex_chunk(
                    spectra, hists[i], *(a[i] for a in per_source),
                    config=config, num_blocks=num_blocks, with_xfade=with_xfade,
                )
                for i in range(hists.shape[0])
            ]
            return torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])

        return fn_per_source

    def fn(spectra, hists, feds, idx_new, w_new, idx_old, w_old, xfade, u_hi, u_lo, inv_frac):
        s = hists.shape[0]
        streams = torch.cat([hists, feds], dim=1)
        new_hists = streams[:, num_blocks * fpb :]
        xr, xi = fft_ops.rfft_sliding_split_batched(streams, num_blocks, fpb, config.pad_len)
        flat = lambda a: a.reshape((s * num_blocks,) + a.shape[2:])
        if with_xfade:
            # per-source extended blend: old[b] == new[b-1] by construction
            idx_ext = torch.cat([idx_old[:, :1], idx_new], dim=1)
            w_ext = torch.cat([w_old[:, :1], w_new], dim=1)
            rows = s * (num_blocks + 1)
            g = blend_channels(spectra, idx_ext.reshape(rows, 4), w_ext.reshape(rows, 4))
            g = tuple(a.reshape(s, num_blocks + 1, -1) for a in g)
            g_old = tuple(flat(a[:, :num_blocks]) for a in g)
            g_new = tuple(flat(a[:, 1:]) for a in g)
        else:
            g_new = blend_channels(spectra, flat(idx_new), flat(w_new))
            g_old = None
        out = apply_filters_core(
            flat(xr), flat(xi), g_old, g_new, flat(xfade),
            flat(u_hi), flat(u_lo), flat(inv_frac),
            config=config, with_xfade=with_xfade,
        )
        return out.reshape(s, num_blocks, fpb, 2), new_hists

    return fn


def batched_chunk_fn_dedup(config: EngineConfig, num_blocks: int, with_xfade: bool = True):
    """The unfused chain on deduplicated blend rows: the unique (index,
    weight) rows of all sources are blended once and broadcast with one row
    gather, the same per-row values as the direct chain.

    Signature: (spectra, hists (S, hist), feds, uniq_idx (U, 4), uniq_w
    (U, 4), inv (S, nb+1) int32 with the crossfade, (S, nb) the new rows
    without, xfade, u_hi, u_lo, inv_frac) -> (outs (S, nb, fpb, 2), new_hists).
    """
    fpb = config.frames_per_buffer
    if config.history_len % fpb:
        raise ValueError("the dedup chain needs history_len % frames_per_buffer == 0")

    def fn(spectra, hists, feds, uniq_idx, uniq_w, inv, xfade, u_hi, u_lo, inv_frac):
        s = hists.shape[0]
        streams = torch.cat([hists, feds], dim=1)
        new_hists = streams[:, num_blocks * fpb :]
        xr, xi = fft_ops.rfft_sliding_split_batched(streams, num_blocks, fpb, config.pad_len)
        flat = lambda a: a.reshape((s * num_blocks,) + a.shape[2:])
        g_cat = blend_cat(cat_table(spectra), uniq_idx, uniq_w)  # (U, 4*bins)
        g = split_planes(g_cat[inv.reshape(-1).long()], config.num_bins)
        if with_xfade:
            g = tuple(a.reshape(s, num_blocks + 1, -1) for a in g)
            g_old = tuple(flat(a[:, :num_blocks]) for a in g)
            g_new = tuple(flat(a[:, 1:]) for a in g)
        else:
            g_old, g_new = None, g
        out = apply_filters_core(
            flat(xr), flat(xi), g_old, g_new, flat(xfade), flat(u_hi), flat(u_lo),
            flat(inv_frac), config=config, with_xfade=with_xfade,
        )
        return out.reshape(s, num_blocks, fpb, 2), new_hists

    return fn


def _apply_only(config: EngineConfig, num_blocks: int, streams, u_hi, u_lo, inv_frac,
                g_rows, g_last, xf, with_xfade: bool):
    """The apply-only step (row 7) for tiles that do not own whole sources:
    the forward planes and distance in plain torch, as XLA computes them in
    the JAX package -> (y (S*nb, 2*fpb), the forward planes (xr, xi))."""
    fpb = config.frames_per_buffer
    rows = streams.shape[0] * num_blocks
    xr, xi = fft_ops.rfft_sliding_split_batched(streams, num_blocks, fpb, config.pad_len)
    xr, xi = xr.reshape(rows, -1), xi.reshape(rows, -1)
    dr, di = distance_factors_split(u_hi.reshape(-1), u_lo.reshape(-1), inv_frac.reshape(-1),
                                    config.num_bins)
    xdr, xdi = cmul(xr, xi, dr, di)
    icr, ici = fft_ops.on_device(fft_ops._idft_tail_matrices, config.pad_len, fpb,
                                 device=streams.device)
    y = fused_apply_xfade(xdr, xdi, g_rows, g_last, xf, icr, ici, seg=num_blocks,
                          bins=config.num_bins, fpb=fpb, with_xfade=with_xfade)
    return y, (xr, xi)


def onehot_step_operands(config: EngineConfig, num_blocks: int, n_dist: int | None,
                         spectra, hists, feds, uniq_ids, ridx, w_old, ridx_last,
                         w_last, xfade, u_hi, u_lo, inv_frac, dsel=None):
    """The one-hot step's operands for one chunk -> (args, kwargs, new_hists):
    ``fused_step_onehot_xfade(*args, **kwargs)`` is the chunk's step, and
    its twin takes the same operands."""
    fpb = config.frames_per_buffer
    s = hists.shape[0]
    b = s * num_blocks
    streams = torch.cat([hists, feds], dim=1)
    new_hists = streams[:, num_blocks * fpb :]
    flat = lambda a: a.reshape((b,) + a.shape[2:])
    col = lambda a: flat(a)[:, None].contiguous()
    table = torch.index_select(cat_table(spectra), 0, uniq_ids)
    if n_dist is None:
        duh, dul, ddf, ds = col(u_hi), col(u_lo), col(inv_frac), None
    else:  # compact distance: (8,) triples + (S, nb) selector
        duh, dul, ddf, ds = u_hi[:, None], u_lo[:, None], inv_frac[:, None], col(dsel)
    args = (streams, duh, dul, ddf, table, flat(ridx), flat(w_old), ridx_last, w_last,
            flat(xfade).to(torch.float32)[:, None])
    kwargs = dict(nb=num_blocks, pad_len=config.pad_len, bins=config.num_bins, fpb=fpb,
                  dsel=ds, n_dist=n_dist)
    return args, kwargs, new_hists


def batched_chunk_fn_fused(config: EngineConfig, num_blocks: int, tb: int, onehot: bool = False,
                           group_tiles: int | None = None, n_dist: int | None = None):
    """The batched fused chunk (crossfade form), as the JAX package's
    ``batched_chunk_fn_fused``.

    ``onehot=True``: the one-hot step against compact tables, one shared
    table (row 1) or, with ``group_tiles``, one per group of that many
    tiles of ``tb`` rows (row 2).  Signature: (spectra, hists (S, hist),
    feds, uniq_ids (U_pad,) or (G*U_pad,), ridx (S, nb, 4), w_old, ridx_last
    (S, 4), w_last, xfade (S, nb), u_hi, u_lo, inv_frac, dsel=None).

    With ``n_dist`` (compact distance) u_hi/u_lo/inv_frac are the (8,)
    unique triples and ``dsel`` (S, nb) selects each block's triple.

    ``onehot=False``: the gather step on blended rows, per-row distance (as
    the JAX dispatch runs it).  Signature: (spectra, hists, feds, idx_old
    (S, nb, 4), w_old, idx_last (S, 4), w_last, xfade, u_hi, u_lo,
    inv_frac).  Tiles of ``tb`` rows that own whole sources (tb % nb == 0)
    take the gather step (row 6), others the apply-only step (row 7).

    -> (outs (S, nb, fpb, 2), new_hists).
    """
    fpb = config.frames_per_buffer
    if config.history_len % fpb:
        raise ValueError("the fused step needs history_len % frames_per_buffer == 0")
    if n_dist is not None and not onehot:
        raise ValueError("the gather step takes per-row distance")
    nb = num_blocks

    def fn_onehot(spectra, hists, *chunk, dsel=None):
        args, kwargs, new_hists = onehot_step_operands(config, nb, n_dist, spectra, hists,
                                                       *chunk, dsel=dsel)
        if group_tiles is not None:
            kwargs.update(tb=tb, group_tiles=group_tiles)
        y = fused_step.fused_step_onehot_xfade(*args, **kwargs)
        return y.reshape(hists.shape[0], nb, 2, fpb).permute(0, 1, 3, 2), new_hists

    def fn(spectra, hists, feds, idx_old, w_old, idx_last, w_last, xfade, u_hi, u_lo, inv_frac):
        s = hists.shape[0]
        streams = torch.cat([hists, feds], dim=1)
        new_hists = streams[:, nb * fpb :]
        flat = lambda a: a.reshape((s * nb,) + a.shape[2:])
        col = lambda a: flat(a)[:, None].contiguous()
        cat = cat_table(spectra)
        g_old = blend_rows(cat, flat(idx_old), flat(w_old))
        g_last = blend_rows(cat, idx_last, w_last)
        xf = flat(xfade).to(torch.float32)[:, None]
        if tb % nb == 0:
            y = fused_step.fused_step_xfade(
                streams, col(u_hi), col(u_lo), col(inv_frac), g_old, g_last, xf, nb=nb,
                pad_len=config.pad_len, bins=config.num_bins, fpb=fpb)
        else:
            y, _ = _apply_only(config, nb, streams, u_hi, u_lo, inv_frac, g_old, g_last, xf, True)
        return y.reshape(s, nb, 2, fpb).permute(0, 1, 3, 2), new_hists

    return fn_onehot if onehot else fn


def batched_chunk_fn_dedup_fused(config: EngineConfig, num_blocks: int, tb: int,
                                 with_xfade: bool = True, n_cf: int | None = None):
    """Dedup + fused composition: blend only the unique (index, weight)
    rows of all sources, broadcast them with one row gather, and run the
    gather step (row 6), or the apply-only step (row 7) when tiles of
    ``tb`` rows do not own whole sources.  Per-row distance, as in the JAX
    package.

    Signature: (spectra, hists (S, hist), feds, uniq_idx (U, 4), uniq_w,
    inv_old (S, nb) int32 — each block's OLD unique row, inv_last (S,) —
    each source's final new row, xfade (S, nb), u_hi, u_lo, inv_frac,
    dsel=None, cf_idx=None, cf_old=None) -> (outs (S, nb, fpb, 2), new_hists).

    ``with_xfade=False``: no block of the chunk crossfades; ``inv_old``
    carries the NEW rows and the step computes their side only.  ``n_cf``
    (sparse crossfades, with with_xfade=False): at most n_cf rows
    crossfade; the no-crossfade step runs for all rows, then the side-pass
    re-blends the ``cf_idx`` rows (row ids source*nb + block), whose old
    unique rows are ``cf_old``.
    """
    fpb = config.frames_per_buffer
    if config.history_len % fpb:
        raise ValueError("the fused step needs history_len % frames_per_buffer == 0")
    sparse = n_cf is not None
    if sparse and with_xfade:
        raise ValueError("the sparse side-pass runs on the no-crossfade step")
    nb = num_blocks

    def fn(spectra, hists, feds, uniq_idx, uniq_w, inv_old, inv_last, xfade, u_hi, u_lo,
           inv_frac, dsel=None, cf_idx=None, cf_old=None):
        s = hists.shape[0]
        streams = torch.cat([hists, feds], dim=1)
        new_hists = streams[:, nb * fpb :]
        flat = lambda a: a.reshape((s * nb,) + a.shape[2:])
        col = lambda a: flat(a)[:, None].contiguous()
        cat = cat_table(spectra)
        g_u = blend_rows(cat, uniq_idx, uniq_w)                # (U, 4*bins)
        g_rows = g_u[inv_old.reshape(-1).long()]               # (S*nb, 4*bins)
        if with_xfade:
            g_last = g_u[inv_last.long()]                      # (S, 4*bins)
            xf = flat(xfade).to(torch.float32)[:, None]
        else:
            g_last, xf = None, None
        planes = None
        if tb % nb == 0:
            y = fused_step.fused_step_xfade(
                streams, col(u_hi), col(u_lo), col(inv_frac), g_rows, g_last, xf, nb=nb,
                pad_len=config.pad_len, bins=config.num_bins, fpb=fpb, with_xfade=with_xfade)
        else:
            y, planes = _apply_only(config, nb, streams, u_hi, u_lo, inv_frac, g_rows, g_last,
                                    xf, with_xfade)
        if sparse:
            # blend only the n_cf old rows the side-pass needs
            old = cf_old.long()
            cf = cf_idx.long()
            g_old_cf = blend_rows(cat, uniq_idx[old], uniq_w[old])
            y = _sparse_xfade_fix(
                y, streams.reshape(-1, fpb), cf, g_old_cf, flat(xfade), flat(u_hi),
                flat(u_lo), flat(inv_frac), config=config, nb_seg=nb,
                xr_cf=None if planes is None else planes[0][cf],
                xi_cf=None if planes is None else planes[1][cf],
            )
        return y.reshape(s, nb, 2, fpb).permute(0, 1, 3, 2), new_hists

    return fn


# Rows per tile below which the JAX package sends wide scenes to the gather
# step instead of per-group tables (a TPU measurement: each tile copies its
# group's table into VMEM; kept so the port takes the JAX package's arms).
GROUPED_MIN_TB = 256

# Target rows per fused step for automatic chunk sizing on hold scenes
# (the JAX package's constant, measured on a TPU; kept so the port chunks
# renders as the reference does).
AUTO_HOLD_ROWS = 8192


def _auto_chunk(s_local: int, b_total: int, plans, fused: bool = True) -> int:
    """Chunk size for ``chunk_blocks=None``, as the JAX package picks it:
    256, lowered by powers of two toward AUTO_HOLD_ROWS rows per step when
    crossfades past block 0 are absent or sparse (<= 1/16 of rows); 512
    for the unfused chain."""
    if not fused:
        return 512
    cb = 256
    if not (s_local and b_total and plans):
        return cb
    cf = sum(int(p.xfade[1:].sum()) for p in plans)
    if cf * 16 <= len(plans) * max(1, b_total - 1):
        while cb > 8 and s_local * cb > AUTO_HOLD_ROWS:
            cb //= 2
    return cb


def _group_bucket(idx_old, idx_last, group: int | None) -> int:
    """Power-of-two bucket covering every source-group's unique-filter set
    (group=None: one group of all sources).  idx_old (S, nb, 4);
    idx_last (S, 4)."""
    s = idx_old.shape[0]
    spans = [(0, s)] if group is None else [(st, st + group) for st in range(0, s, group)]
    m = 1
    for st, sp in spans:
        ids = np.concatenate([idx_old[st:sp].reshape(-1), idx_last[st:sp].reshape(-1)])
        m = max(m, len(np.unique(ids)))
    return max(8, 1 << int(np.ceil(np.log2(m))))


def _plan_source_groups(idx_old, idx_last, s_local: int, tb_sources: int):
    """(group_sources, u_pad) for the grouped one-hot step, or (None,
    None): groups are whole multiples of the tile's sources and divide the
    source count; halve from ``s_local`` until every group's unique set
    fits MAX_ONEHOT_U."""
    s = idx_old.shape[0]
    group = s_local
    while True:
        if group < tb_sources or group % tb_sources or s % group:
            return None, None
        u_pad = _group_bucket(idx_old, idx_last, group)
        if u_pad <= fused_step.MAX_ONEHOT_U:
            return group, u_pad
        if group // 2 < tb_sources or group % 2:
            return None, None
        group //= 2


def _plan_batch_onehot(plans, b_total: int, cb: int, s_local: int):
    """Render-wide one-hot plan, as the JAX package makes it: ('shared',
    u_pad) — one table bucket for every chunk — or ('grouped', g_srcs,
    u_pad) — per-source-group tables, one group size and bucket for every
    chunk — or None (the gather step).  Group viability is monotone (a
    sub-group's unique set is a subset), so the render-wide group is the
    smallest of the chunks' groups and the bucket the largest at that
    group."""
    spans = [(st, min(st + cb, b_total)) for st in range(0, b_total, cb)]

    def chunk_arrays(start, stop):
        return (np.stack([p.idx_old[start:stop] for p in plans]),
                np.stack([p.idx_new[stop - 1] for p in plans]))

    shared, g_min = 1, None
    for start, stop in spans:
        io, il = chunk_arrays(start, stop)
        shared = max(shared, _group_bucket(io, il, None))
        if shared > fused_step.MAX_ONEHOT_U and g_min != 0:
            g, _ = _plan_source_groups(io, il, s_local, 1)
            g_min = 0 if g is None else min(g, g_min or g)
    if shared <= fused_step.MAX_ONEHOT_U:
        return ("shared", shared)
    if not g_min:
        return None
    u = 1
    for start, stop in spans:
        u = max(u, _group_bucket(*chunk_arrays(start, stop), g_min))
    return None if u > fused_step.MAX_ONEHOT_U else ("grouped", g_min, u)


def group_tile(s_local: int, cb: int, g_srcs: int) -> int | None:
    """The grouped one-hot step's tile, as the JAX dispatch re-picks it
    inside a group of ``g_srcs`` sources: at most 256 rows, owning whole
    sources and never straddling a group; one source per tile when the
    default tile does neither; None when no tile fits."""
    tb = pick_fused_tile(s_local * cb, cb, max_tb=min(256, g_srcs * cb))
    if tb is not None and (tb % cb or (g_srcs * cb) % tb):
        tb = cb if cb % 8 == 0 and cb <= 256 else None
    return tb


def _plan_dedup(plans, b_total: int, cb: int):
    """The render-wide dedup plan of the JAX BatchRenderer: each chunk's
    unique extended rows ([old row of block 0, new rows], all sources) with
    one bucket for the render -> ([(uniq_idx, uniq_w, inv (S, cb+1))],
    u_pad), or None when the bucket exceeds half the chunk's extended rows
    (sources that do not hold their positions)."""
    chunks, max_u = [], 1
    for start in range(0, b_total, cb):
        sl = slice(start, min(start + cb, b_total))
        ei = np.concatenate([np.stack([p.idx_old[start : start + 1] for p in plans]),
                             np.stack([p.idx_new[sl] for p in plans])], axis=1)
        ew = np.concatenate([np.stack([p.w_old[start : start + 1] for p in plans]),
                             np.stack([p.w_new[sl] for p in plans])], axis=1)
        rows = ei.shape[0] * ei.shape[1]
        uniq_idx, uniq_w, inv = dedup_rows(ei.reshape(rows, 4), ew.reshape(rows, 4))
        max_u = max(max_u, uniq_idx.shape[0])
        chunks.append((uniq_idx, uniq_w, inv.reshape(ei.shape[:2])))
    u_pad = max(8, 1 << int(np.ceil(np.log2(max_u))))
    if u_pad * 2 > len(plans) * (min(cb, b_total) + 1):
        return None
    return chunks, u_pad


def _dedup_chunk(dedup, ci: int):
    """Chunk ``ci``'s (uniq_idx, uniq_w, inv), the unique rows padded to the
    render's bucket by repeating the last one."""
    chunks, u_pad = dedup
    uniq_idx, uniq_w, inv = chunks[ci]
    reps = u_pad - uniq_idx.shape[0]
    uniq_idx = np.concatenate([uniq_idx, np.repeat(uniq_idx[-1:], reps, 0)])
    uniq_w = np.concatenate([uniq_w, np.repeat(uniq_w[-1:], reps, 0)])
    return uniq_idx, uniq_w, inv


def mix_sources(outs: torch.Tensor) -> torch.Tensor:
    """(S, nb, fpb, 2) per-source stereo -> (nb, fpb, 2) mixed (summed, like
    the reference's output accumulation, reference: Jefferson/src/Audio.cu:109)."""
    return torch.sum(outs, dim=0)


class BatchRenderer:
    """Render S concurrent independent source streams, on one device or
    sharded over a source mesh.

    signals: (S, n) float32 — one mono stream per source; positions:
    (S, B, 3) per-block (azi, ele, r); ``config`` the engine geometry,
    ``db.config`` when None.  Chunks of ``chunk_blocks`` blocks
    (None: the JAX package's automatic size) carry the overlap-save history
    from chunk to chunk; the final chunk is padded and the output trimmed.

    Each chunk takes the arm the JAX ``BatchRenderer`` takes, recorded in
    ``dispatch`` as (arm, with_xfade, sparse bucket) with the arm names of
    ``jefferson_tpu.bench.sweep._batch_dispatches``: "dedup_fused" (sources
    that hold their positions: rows 6 and 7 with the no-crossfade and
    sparse forms), "onehot_shared" (row 1), "onehot_grouped" (row 2),
    "gather_fused" (rows 6 and 7), and with ``fused=False`` or no fused
    tile "dedup" and "plain" (the JAX package's XLA arms, here plain
    torch).  It runs on the card unless the caller asks for the CPU:
    ``device="cpu"`` runs the kernels' twins.  ``dedup`` and
    ``sparse_xfade`` are the JAX package's switches; a history that is not
    a whole number of blocks takes the unfused chain, as there.
    ``timings`` holds the last render's host seconds: ``planning_s`` (plans,
    chunk size, dedup, one-hot and sparse planning) and ``chunks_s`` (the
    chunk loop: operands, launches, collectives, output copies, and the
    output's assembly).  ``pipeline_fetch=True`` fetches each chunk's
    output one chunk late, after the next chunk is launched
    (``renderer.ChunkFetch``), bit-identical to the default synchronous
    fetch.

    ``mesh``: a 1-D ``DeviceMesh`` (``parallel.mesh.make_mesh``) shards the
    source axis, SPMD: every rank of the mesh calls ``render`` with the
    whole inputs, plans the whole batch as the JAX package does (the dedup
    rows, the compact distance, the one-hot plan on S / mesh size sources,
    the sparse bucket per shard), keeps the replicated operands whole (the
    unique blend rows, the shared one-hot table, the distance triples),
    takes its own contiguous sources of the per-source operands (and its
    groups' tables), and runs its chunk through the arm and kernel the JAX
    package's ``shard_map`` runs.  Each chunk ends in one collective: the
    mixdown's ``mix_all_reduce`` with ``mix=True``, else ``gather_rows``;
    every rank returns the whole result.  A mesh that does not divide S
    renders every source on every rank through the unfused arms, with no
    collective, as the JAX package's replicated XLA path does.

    The JAX package's fallback from a failed fused program to the XLA arms,
    and its redo of a chunk whose deferred fetch failed, are not carried
    over: a failed build or launch raises, and so does a deferred fetch.
    """

    def __init__(self, db: HRTFDatabase, config: EngineConfig | None = None, *, device="cuda",
                 chunk_blocks: int | None = None, mix: bool = False, dedup: bool = True,
                 fused: bool = True, sparse_xfade: bool = True, mesh=None,
                 pipeline_fetch: bool = False):
        if mesh is not None and check_mesh(mesh).ndim != 1:
            # the shard planning reads the mesh's size as the SOURCE shard
            # count, which it is only on a 1-D mesh
            raise ValueError(
                f"BatchRenderer needs a 1-D source mesh, got axes {mesh.mesh_dim_names}")
        if chunk_blocks is not None and chunk_blocks < 1:
            raise ValueError(f"chunk_blocks ({chunk_blocks}) must be positive")
        self.db = db
        self.config = config or db.config
        aligned = self.config.history_len % self.config.frames_per_buffer == 0
        self.chunk_blocks = chunk_blocks
        self.mesh = mesh
        self.mix = mix
        self.pipeline_fetch = pipeline_fetch
        self.dedup = dedup and aligned
        self.fused = fused and aligned
        if self.fused and torch.device(device).type == "cuda":
            check_card_geometry(self.config)
        self.device = resolve_device(device)
        self.sparse_xfade = sparse_xfade
        self.dispatch: list[tuple[str, bool, int | None]] = []
        self.timings: dict[str, float] = {}
        self._spectra = spectra_from_numpy(db.spectra, self.device)

    def _put(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def render(self, signals: np.ndarray, positions: np.ndarray) -> np.ndarray:
        """signals (S, n); positions (S, B, 3) -> (S, B*fpb, 2) or mixed (B*fpb, 2)."""
        t0 = time.perf_counter()
        cfg = self.config
        fpb = cfg.frames_per_buffer
        signals = np.asarray(signals, dtype=np.float32)
        positions = np.asarray(positions)
        s, b_total = positions.shape[0], positions.shape[1]
        plans = [make_plan(positions[i], cfg) for i in range(s)]
        # the sources each device renders (no fused arm when the mesh does
        # not divide them) and this rank's [lo, hi) of them
        n_dev = self.mesh.size() if self.mesh is not None else 1
        s_local = s // n_dev if s % n_dev == 0 else 0
        sharded = self.mesh is not None and s_local > 0
        lo, hi = source_range(self.mesh, s) if sharded else (0, s)
        cb = self.chunk_blocks or _auto_chunk(s_local or s, b_total, plans,
                                              fused=self.fused and s_local > 0)
        b_real = b_total
        if b_total % cb:  # pad the final chunk to the fixed size; trimmed below
            pad_b = cb - b_total % cb
            plans = [pad_plan(p, pad_b) for p in plans]
            b_total += pad_b
        mine = plans[lo:hi]
        feds = np.stack([fed_stream(signals[i], b_total, cfg) for i in range(lo, hi)])
        stack = lambda attr, sl: np.stack([getattr(p, attr)[sl] for p in mine])

        dedup = _plan_dedup(plans, b_total, cb) if self.dedup else None
        # sparse crossfades: one no-crossfade step + side-pass for every
        # chunk when every (chunk, shard)'s crossfade count fits a small
        # bucket
        sparse_ncf = None
        if dedup is not None and self.fused and self.sparse_xfade and s_local:
            max_ncf = max(int(sum(p.xfade[st : st + cb].sum()
                                  for p in plans[d * s_local : (d + 1) * s_local]))
                          for st in range(0, b_total, cb) for d in range(n_dev))
            sparse_ncf = _sparse_bucket(max_ncf, s_local * cb)
        chunk_xfs = _apply_xfade_amortization([
            bool(any(p.xfade[st : st + cb].any() for p in plans)) for st in range(0, b_total, cb)
        ])
        onehot_plan = None
        if self.fused and dedup is None and s_local:
            onehot_plan = _plan_batch_onehot(plans, b_total, cb, s_local)
        if onehot_plan is not None:
            # compact distance across the whole batch, for the one-hot arms:
            # constant-radius scenes give a handful of unique triples
            dist = dedup_distance(*(np.concatenate([getattr(p, a) for p in plans])
                                    for a in ("u_hi", "u_lo", "inv_frac")))
            nd = None if dist is None else dist[4]
            if dist is not None:
                triples = tuple(self._put(a) for a in dist[:3])
                dsel_all = dist[3].reshape(s, b_total)[lo:hi]
        t1 = time.perf_counter()

        hists = torch.zeros((hi - lo, cfg.history_len), dtype=torch.float32, device=self.device)
        self.dispatch = []
        out = np.empty((b_real * fpb, 2) if self.mix else (s, b_real * fpb, 2), np.float32)
        fetch = ChunkFetch(self.device, self.pipeline_fetch)
        for ci, start in enumerate(range(0, b_total, cb)):
            stop = start + cb
            sl = slice(start, stop)
            fed = self._put(feds[:, start * fpb : stop * fpb])
            xfade_np = stack("xfade", sl)
            row_dist = tuple(self._put(stack(a, sl)) for a in ("u_hi", "u_lo", "inv_frac"))
            cxf = chunk_xfs[ci]
            tb = pick_fused_tile(s_local * cb, cb) if self.fused and s_local else None
            if tb is not None and dedup is not None:
                uniq_idx, uniq_w, inv = _dedup_chunk(dedup, ci)
                inv = inv[lo:hi]
                dxf = cxf and sparse_ncf is None
                cf = {}
                if sparse_ncf is not None:
                    # this shard's crossfading rows, as shard-local row ids
                    cfi = _pad_cf_indices(xfade_np.reshape(-1), sparse_ncf)
                    cf = dict(cf_idx=self._put(cfi.astype(np.int32)),
                              cf_old=self._put(inv[:, :cb].reshape(-1)[cfi]))
                fn = batched_chunk_fn_dedup_fused(cfg, cb, tb, with_xfade=dxf, n_cf=sparse_ncf)
                # extended rows are [old row of block 0, new rows 0..cb-1]:
                # [:cb] is old-aligned, [1:] the new rows, [cb] the last new row
                y, hists = fn(self._spectra, hists, fed, self._put(uniq_idx), self._put(uniq_w),
                              self._put(inv[:, :cb] if dxf else inv[:, 1:]),
                              self._put(inv[:, cb]), self._put(xfade_np), *row_dist, **cf)
                arm = ("dedup_fused", dxf, sparse_ncf)
            elif tb is not None:
                # the compact tables are planned on every source: one shared
                # table is replicated, the grouped tables split by group
                idx_old = np.stack([p.idx_old[sl] for p in plans])
                idx_last = np.stack([p.idx_new[stop - 1] for p in plans])
                onehot, group_tiles = False, None
                if onehot_plan is not None and onehot_plan[0] == "shared":
                    onehot = tb % cb == 0  # the one-hot step's tiles own whole sources
                elif onehot_plan is not None:
                    # per-source-group tables; the tile is re-picked inside
                    # the group, owns whole sources and never straddles one
                    _, g_srcs, g_upad = onehot_plan
                    tb_g = group_tile(s_local, cb, g_srcs)
                    if tb_g is not None and tb_g >= GROUPED_MIN_TB:
                        onehot, tb, group_tiles = True, tb_g, (g_srcs * cb) // tb_g
                w_args = (self._put(stack("w_old", sl)),)
                last_w = self._put(stack("w_new", stop - 1))
                if onehot and group_tiles is not None:
                    uniq_ids, ridx, ridx_last = compact_filter_ids_grouped_sources(
                        idx_old, idx_last, g_srcs, g_upad)
                    uniq_ids = uniq_ids[lo // g_srcs * g_upad : hi // g_srcs * g_upad]
                elif onehot:
                    uniq_ids, ridx, ridx_last, _ = compact_filter_ids(
                        idx_old, idx_last, u_pad=onehot_plan[1])
                if onehot:
                    head = (self._put(uniq_ids), self._put(ridx[lo:hi]))
                    last = self._put(ridx_last[lo:hi])
                    d_args, dsel = (row_dist, {}) if nd is None else (
                        triples, {"dsel": self._put(dsel_all[:, sl])})
                    arm = ("onehot_grouped" if group_tiles is not None else "onehot_shared",
                           True, None)
                else:
                    head, last = (self._put(idx_old[lo:hi]),), self._put(idx_last[lo:hi])
                    d_args, dsel = row_dist, {}
                    arm = ("gather_fused", True, None)
                fn = batched_chunk_fn_fused(cfg, cb, tb, onehot=onehot, group_tiles=group_tiles,
                                            n_dist=nd if onehot else None)
                y, hists = fn(self._spectra, hists, fed, *head, *w_args, last, last_w,
                              self._put(xfade_np), *d_args, **dsel)
            elif dedup is not None:
                uniq_idx, uniq_w, inv = _dedup_chunk(dedup, ci)
                inv = inv[lo:hi]
                fn = batched_chunk_fn_dedup(cfg, cb, with_xfade=cxf)
                y, hists = fn(self._spectra, hists, fed, self._put(uniq_idx), self._put(uniq_w),
                              self._put(inv if cxf else inv[:, 1:]), self._put(xfade_np),
                              *row_dist)
                arm = ("dedup", cxf, None)
            else:
                fn = batched_chunk_fn(cfg, cb, with_xfade=cxf)
                y, hists = fn(self._spectra, hists, fed,
                              *(self._put(stack(a, sl)) for a in ("idx_new", "w_new", "idx_old",
                                                                  "w_old")),
                              self._put(xfade_np), *row_dist)
                arm = ("plain", cxf, None)
            self.dispatch.append(arm)
            if self.mix:
                y = mix_sources(y)
                if sharded:
                    y = mix_all_reduce(y, self.mesh)
            elif sharded:
                y = gather_rows(y, self.mesh)

            def commit(host, start=start):
                # (S,) cb, fpb, 2 -> the chunk's rows of out, the padding trimmed
                rows = (min(b_real, start + cb) - start) * fpb
                dst = out[..., start * fpb : start * fpb + rows, :]
                dst[...] = host.reshape(*host.shape[:-3], cb * fpb, 2)[..., :rows, :]

            fetch.put(y, commit)
        fetch.finish()
        self.timings = {"planning_s": t1 - t0, "chunks_s": time.perf_counter() - t1}
        return out
