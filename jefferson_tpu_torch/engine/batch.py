"""Multi-source batched rendering on one device.

Counterpart of ``jefferson_tpu/engine/batch.py`` for the main path: the
unfused chain (``batched_chunk_fn``), the batched one-hot fused step with
one shared compact table (``batched_chunk_fn_fused``), the render-wide
planning the JAX dispatch uses to choose that form, and a reduced
``BatchRenderer``.  Sources are a leading batch axis; after the forward
transform, sources x blocks are independent rows of one tall matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from jefferson_tpu.config import EngineConfig
from jefferson_tpu.hrtf.kemar import HRTFDatabase

from ..convert import spectra_from_numpy
from ..kernels import fused_step
from ..ops import fft as fft_ops
from .plan import compact_filter_ids, dedup_rows, fed_stream, make_plan, pad_plan
from .renderer import (
    _fd_complex_chunk, apply_filters_core, blend_channels, cat_table, dedup_distance,
    pick_fused_tile,
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


def onehot_step_operands(config: EngineConfig, num_blocks: int, n_dist: int | None,
                         spectra, hists, feds, uniq_ids, ridx, w_old, ridx_last,
                         w_last, xfade, u_hi, u_lo, inv_frac, dsel=None):
    """The fused step's operands for one chunk -> (args, kwargs, new_hists):
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


def batched_chunk_fn_fused(config: EngineConfig, num_blocks: int, n_dist: int | None = None):
    """The batched one-hot fused chunk with one shared compact table (the
    JAX package's ``batched_chunk_fn_fused(onehot=True, group_tiles=None)``).

    Signature: (spectra, hists (S, hist), feds, uniq_ids (U_pad,), ridx
    (S, nb, 4), w_old, ridx_last (S, 4), w_last, xfade (S, nb), u_hi, u_lo,
    inv_frac, dsel=None) -> (outs (S, nb, fpb, 2), new_hists).  With
    ``n_dist`` (compact distance) u_hi/u_lo/inv_frac are the (8,) unique
    triples and ``dsel`` (S, nb) selects each block's triple.
    """
    fpb = config.frames_per_buffer
    if config.history_len % fpb:
        raise ValueError("the fused step needs history_len % frames_per_buffer == 0")

    def fn(spectra, hists, *chunk, dsel=None):
        args, kwargs, new_hists = onehot_step_operands(
            config, num_blocks, n_dist, spectra, hists, *chunk, dsel=dsel
        )
        y = fused_step.fused_step_onehot_xfade(*args, **kwargs)
        s = hists.shape[0]
        return y.reshape(s, num_blocks, 2, fpb).permute(0, 1, 3, 2), new_hists

    return fn


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


def _plan_batch_onehot(plans, b_total: int, cb: int):
    """('shared', u_pad) — one compact-table bucket for every chunk of the
    render — when every chunk's unique-filter set fits MAX_ONEHOT_U, else
    None.  The JAX package's planner then returns a grouped plan or None
    (gather blend); neither form is ported yet."""
    shared = 1
    for start in range(0, b_total, cb):
        stop = min(start + cb, b_total)
        io = np.stack([p.idx_old[start:stop] for p in plans])
        il = np.stack([p.idx_new[stop - 1] for p in plans])
        shared = max(shared, _group_bucket(io, il, None))
    return ("shared", shared) if shared <= fused_step.MAX_ONEHOT_U else None


def mix_sources(outs: torch.Tensor) -> torch.Tensor:
    """(S, nb, fpb, 2) per-source stereo -> (nb, fpb, 2) mixed (summed, like
    the reference's output accumulation, reference: Jefferson/src/Audio.cu:109)."""
    return torch.sum(outs, dim=0)


def _is_hold_scene(plans, b_total: int, cb: int) -> bool:
    """Whether the JAX BatchRenderer would take its dedup path: the unique
    (indices, weights) rows of every chunk fit a bucket at most half the
    chunk's extended rows (sources that mostly hold their positions)."""
    s, max_u = len(plans), 1
    for start in range(0, b_total, cb):
        sl = slice(start, min(start + cb, b_total))
        ei = np.concatenate([np.stack([p.idx_old[start : start + 1] for p in plans]),
                             np.stack([p.idx_new[sl] for p in plans])], axis=1)
        ew = np.concatenate([np.stack([p.w_old[start : start + 1] for p in plans]),
                             np.stack([p.w_new[sl] for p in plans])], axis=1)
        rows = ei.shape[0] * ei.shape[1]
        max_u = max(max_u, dedup_rows(ei.reshape(rows, 4), ew.reshape(rows, 4))[0].shape[0])
    u_pad = max(8, 1 << int(np.ceil(np.log2(max_u))))
    return u_pad * 2 <= s * (min(cb, b_total) + 1)


class BatchRenderer:
    """Render S concurrent independent source streams on one device.

    signals: (S, n) float32 — one mono stream per source; positions:
    (S, B, 3) per-block (azi, ele, r).  Chunks of ``chunk_blocks`` blocks
    (None: the JAX package's automatic size) carry the overlap-save history
    from chunk to chunk; the final chunk is padded and the output trimmed.

    ``fused=True`` runs every chunk through the CUDA step (its twin for
    ``device="cpu"``); it raises NotImplementedError where the JAX package
    would leave the shared one-hot form, naming the ROADMAP item that ports
    the missing form.  ``fused=False`` runs the unfused chain, the JAX
    package's own ``fused=False`` arm.
    """

    def __init__(self, db: HRTFDatabase, *, device, chunk_blocks: int | None = None,
                 mix: bool = False, fused: bool = True):
        self.db = db
        self.config = db.config
        self.device = torch.device(device)
        if chunk_blocks is not None and chunk_blocks < 1:
            raise ValueError(f"chunk_blocks ({chunk_blocks}) must be positive")
        if fused and self.config.history_len % self.config.frames_per_buffer:
            raise ValueError("the fused step needs history_len % frames_per_buffer == 0; "
                             "use fused=False")
        self.chunk_blocks = chunk_blocks
        self.mix = mix
        self.fused = fused
        self._spectra = spectra_from_numpy(db.spectra, self.device)

    def _put(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _check_one_hot_form(self, plans, b_total: int, cb: int, s: int) -> int:
        """The render-wide compact-table bucket, or raise where the JAX
        dispatch would take a form that is not ported yet."""
        if _is_hold_scene(plans, b_total, cb):
            raise NotImplementedError(
                "hold scene: the JAX package renders it through the dedup+fused "
                "gather form (kernel row 6, ROADMAP queue 2 item 1), not ported yet"
            )
        plan = _plan_batch_onehot(plans, b_total, cb)
        if plan is None:
            raise NotImplementedError(
                f"wide scene: more unique filters per chunk than MAX_ONEHOT_U="
                f"{fused_step.MAX_ONEHOT_U}; the JAX package uses grouped tables "
                "(kernel row 2, ROADMAP queue 2 item 2) or the gather form "
                "(kernel row 6, item 1), not ported yet"
            )
        tb = pick_fused_tile(s * cb, cb)
        if tb is None:
            raise ValueError(f"chunk_blocks={cb} has no fused tile (the JAX package "
                             "renders it through the unfused chain); use fused=False")
        if tb % cb:
            raise NotImplementedError(
                f"chunk_blocks={cb} > 256: the JAX package renders it through the "
                "apply-only form (kernel row 7, ROADMAP queue 2 item 3), not ported yet"
            )
        return plan[1]

    def render(self, signals: np.ndarray, positions: np.ndarray) -> np.ndarray:
        """signals (S, n); positions (S, B, 3) -> (S, B*fpb, 2) or mixed (B*fpb, 2)."""
        cfg = self.config
        fpb = cfg.frames_per_buffer
        signals = np.asarray(signals, dtype=np.float32)
        positions = np.asarray(positions)
        s, b_total = positions.shape[0], positions.shape[1]
        plans = [make_plan(positions[i], cfg) for i in range(s)]
        cb = self.chunk_blocks or _auto_chunk(s, b_total, plans, fused=self.fused)
        b_real = b_total
        if b_total % cb:  # pad the final chunk to the fixed size; trimmed below
            pad_b = cb - b_total % cb
            plans = [pad_plan(p, pad_b) for p in plans]
            b_total += pad_b
        feds = np.stack([fed_stream(signals[i], b_total, cfg) for i in range(s)])
        hists = torch.zeros((s, cfg.history_len), dtype=torch.float32, device=self.device)
        stack = lambda attr, sl: np.stack([getattr(p, attr)[sl] for p in plans])

        if self.fused:
            u_pad = self._check_one_hot_form(plans, b_total, cb, s)
            # compact distance across the whole batch: constant-radius scenes
            # give a handful of unique triples
            dist = dedup_distance(*(np.concatenate([getattr(p, a) for p in plans])
                                    for a in ("u_hi", "u_lo", "inv_frac")))
            nd = None if dist is None else dist[4]
            fn = batched_chunk_fn_fused(cfg, cb, n_dist=nd)
            if dist is not None:
                triples = tuple(self._put(a) for a in dist[:3])
                dsel_all = dist[3].reshape(s, b_total)

        outs = []
        for start in range(0, b_total, cb):
            stop = start + cb
            sl = slice(start, stop)
            fed = self._put(feds[:, start * fpb : stop * fpb])
            xfade = self._put(stack("xfade", sl))
            if self.fused:
                uniq_ids, ridx, ridx_last, _ = compact_filter_ids(
                    stack("idx_old", sl), stack("idx_new", stop - 1), u_pad=u_pad
                )
                dist_args = (
                    triples if nd is not None
                    else tuple(self._put(stack(a, sl)) for a in ("u_hi", "u_lo", "inv_frac"))
                )
                y, hists = fn(
                    self._spectra, hists, fed, self._put(uniq_ids), self._put(ridx),
                    self._put(stack("w_old", sl)), self._put(ridx_last),
                    self._put(stack("w_new", stop - 1)), xfade, *dist_args,
                    dsel=None if nd is None else self._put(dsel_all[:, sl]),
                )
            else:
                chain = batched_chunk_fn(cfg, cb, with_xfade=bool(stack("xfade", sl).any()))
                y, hists = chain(
                    self._spectra, hists, fed,
                    *(self._put(stack(a, sl)) for a in ("idx_new", "w_new", "idx_old", "w_old")),
                    xfade,
                    *(self._put(stack(a, sl)) for a in ("u_hi", "u_lo", "inv_frac")),
                )
            outs.append((mix_sources(y) if self.mix else y).cpu().numpy())
        if self.mix:
            return np.concatenate(outs, axis=0).reshape(b_total * fpb, 2)[: b_real * fpb]
        return np.concatenate(outs, axis=1).reshape(s, b_total * fpb, 2)[:, : b_real * fpb]
