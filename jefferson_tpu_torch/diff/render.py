"""Differentiable binaural rendering: inverse rendering and source
localization on torch autograd.

Counterpart of ``jefferson_tpu/diff/render.py``.  The pipeline is linear in
the HRTF filters, so with *smooth* interpolation weights (no degree
rounding, no C-truncation quirks, proper azimuth wraparound) the render is
differentiable in the source trajectory (azi, ele, r), and a trajectory can
be recovered from a binaural recording and its dry signal by descending the
waveform loss.  The parity engine (``engine/renderer.py``) keeps the
reference's quirks; this module is the clean variant for optimization and
runs on plain PyTorch ops, no kernel of the port: the JAX module reaches no
Pallas kernel either.

Three places where the obvious translation computes another function:

* ``clip`` is ``min(max(x, lo), hi)``, as ``jnp.clip`` is: at a bound its
  gradient is 0.5 (a tie of max or min splits it), where ``torch.clamp``
  passes all of it.  The grid's candidates sit on such bounds (every 10
  degrees of elevation; every ring of 5-degree increments), so every
  descent starts on one.
* The KEMAR ring tables stay float32 and int32 and the distance phase keeps
  the JAX expression's order, ``2π·fsvs`` rounded to float32 first.
* The smoother pads (w-1)//2 zeros before and the rest after, as XLA's
  ``SAME`` does.

``jax.vmap`` over grid candidates becomes batching over a leading
candidate axis, and ``optax.adam`` becomes ``torch.optim.Adam``, a fresh
one per lowpass width as the JAX descent builds a fresh state.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..config import EngineConfig
from ..engine.plan import fed_stream
from ..engine.renderer import resolve_device
from ..hrtf.kemar import AZIMUTH_COUNTS, AZIMUTH_INC, AZIMUTH_OFFSET, ELEVATIONS, HRTFDatabase
from ..ops import fft as fft_ops

GRID_CHUNK = 256  # grid candidates per batched evaluation: bounds the (chunk, b, bins) planes
LOSS_SCALE = 1e4  # the waveform MSE's scale, for the optimizer's health
_TOP_ROW = len(ELEVATIONS) - 1


@functools.lru_cache(maxsize=8)
def _ring_tables(device: torch.device):
    """Each elevation ring's azimuth increment and count (float32) and its
    first filter index (int32), on ``device``."""
    return (torch.from_numpy(np.asarray(AZIMUTH_INC, np.float32)).to(device),
            torch.from_numpy(np.asarray(AZIMUTH_COUNTS, np.float32)).to(device),
            torch.from_numpy(np.asarray(AZIMUTH_OFFSET[:-1], np.int32)).to(device))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` with its gradient: 0.5 at a bound."""
    return torch.minimum(torch.maximum(x, torch.tensor(lo, dtype=x.dtype)),
                         torch.tensor(hi, dtype=x.dtype))


def smooth_coeffs(azi: torch.Tensor, ele: torch.Tensor):
    """Smooth bilinear interpolation over the KEMAR grid.

    azi, ele: (...,) float32 degrees (azi wraps mod 360; ele clipped to
    [-40, 90]).  Returns (indices (..., 4) int64, weights (..., 4) float32);
    the weights are differentiable in (azi, ele) almost everywhere and sum
    to 1.
    """
    inc_t, counts_t, offset_t = _ring_tables(azi.device)
    azi = torch.remainder(azi, 360.0)
    ele = clip(ele, -40.0, 90.0)
    row_f = (ele + 40.0) / 10.0
    row0 = torch.floor(row_f.detach()).clamp(0, _TOP_ROW).long()
    row1 = torch.clamp(row0 + 1, max=_TOP_ROW)
    fe = clip(row_f - row0.to(torch.float32), 0.0, 1.0)

    def row_bracket(row):
        inc = inc_t[row]
        n = counts_t[row].long()
        j_f = torch.floor(azi / inc)
        j = torch.remainder(j_f.long(), n)
        j1 = torch.remainder(j + 1, n)
        fa = clip((azi - j_f * inc) / inc, 0.0, 1.0)
        return offset_t[row] + j, offset_t[row] + j1, fa

    i00, i01, fa0 = row_bracket(row0)
    i10, i11, fa1 = row_bracket(row1)
    idx = torch.stack([i00, i01, i10, i11], dim=-1)
    w = torch.stack([(1 - fa0) * (1 - fe), fa0 * (1 - fe), (1 - fa1) * fe, fa1 * fe], dim=-1)
    return idx, w


@functools.lru_cache(maxsize=16)
def _window(width: int, device: torch.device) -> torch.Tensor:
    win = np.hanning(width)
    return torch.from_numpy((win / win.sum()).astype(np.float32)).to(device).view(1, 1, width)


def smooth(blocks: torch.Tensor, width: int) -> torch.Tensor:
    """(..., B, fpb, 2) -> the same with each ear's stream (its B blocks in
    a row) lowpassed by a normalized Hann window of ``width`` taps: a
    cross-correlation with XLA's ``SAME`` padding, (width-1)//2 zeros before
    and the rest after.  Width 1 or less is the identity."""
    if width <= 1:
        return blocks
    *lead, b, fpb, ears = blocks.shape
    t = F.pad(blocks.movedim(-1, -3).reshape(-1, 1, b * fpb),
              ((width - 1) // 2, width - 1 - (width - 1) // 2))
    y = F.conv1d(t, _window(width, blocks.device))
    return y.reshape(*lead, ears, b, fpb).movedim(-3, -1)


def _f32(x, device) -> torch.Tensor:
    """A caller's array or tensor as a float32 tensor on ``device``, out of
    any graph."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=device)


class DifferentiableRenderer:
    """Smooth, autograd-compatible offline renderer.

    ``render(signal, positions)`` with positions (B, 3) = (azi, ele, r), a
    float32 tensor that may require grad, returns (B*fpb, 2) on the
    renderer's device; gradients flow to the positions.  The filter table
    moves to the device once, here.  ``device="cuda"`` without a card
    raises; nothing falls back to the CPU.  ``timings`` holds the last
    ``localize`` call's stages: wall seconds and step counts.
    """

    def __init__(self, db: HRTFDatabase, config: EngineConfig | None = None, device="cuda"):
        self.db = db
        self.config = config or db.config
        self.device = resolve_device(device)
        sp = db.spectra
        self._tabs = tuple(
            torch.from_numpy(np.ascontiguousarray(plane[:, ch, :], np.float32)).to(self.device)
            for plane in (np.real(sp), np.imag(sp))
            for ch in (0, 1)
        )  # (rL, rR, iL, iR)
        cfg = self.config
        self._k = torch.arange(cfg.num_bins, dtype=torch.float32, device=self.device)
        # float32 scalars, exact as Python floats: 2π·fsvs is rounded to
        # float32 before it meets the radii, as in the JAX expression
        self._fsvs = float(np.float32(cfg.fsvs))
        self._two_pi_fsvs = float(np.float32(2.0 * np.pi) * np.float32(cfg.fsvs))
        self.timings: dict[str, float] = {}

    def _forward(self, signal: np.ndarray, num_blocks: int):
        cfg = self.config
        fed = fed_stream(np.asarray(signal, np.float32), num_blocks, cfg)
        stream = np.concatenate([np.zeros(cfg.history_len, np.float32), fed])
        return fft_ops.rfft_sliding_split(torch.from_numpy(stream).to(self.device), num_blocks,
                                          cfg.frames_per_buffer, cfg.pad_len)

    def render_spectra(self, xr: torch.Tensor, xi: torch.Tensor,
                       positions: torch.Tensor) -> torch.Tensor:
        """Differentiable core: forward planes (B, bins) and positions
        (..., B, 3) -> (..., B, fpb, 2); leading axes batch candidates."""
        cfg = self.config
        azi, ele, r = positions[..., 0], positions[..., 1], positions[..., 2]
        idx, w = smooth_coeffs(azi, ele)
        hr_l, hr_r, hi_l, hi_r = self._tabs

        # smooth distance factor (the engine's formula, fp32 direct)
        rs = r / cfg.distance_scale
        arg = self._two_pi_fsvs * rs[..., None] * self._k / cfg.num_bins
        inv_frac = (1.0 / (1.0 + self._fsvs * rs * rs))[..., None]
        dr = torch.cos(arg) * inv_frac
        di = -torch.sin(arg) * inv_frac
        xdr = xr * dr - xi * di
        xdi = xr * di + xi * dr

        def blend(tab):
            g = w[..., 0:1] * tab[idx[..., 0]]
            for j in range(1, 4):
                g = g + w[..., j:j + 1] * tab[idx[..., j]]
            return g

        qs_r, qs_i = [], []
        for gr_t, gi_t in ((hr_l, hi_l), (hr_r, hi_r)):
            gr, gi = blend(gr_t), blend(gi_t)
            qs_r.append(xdr * gr - xdi * gi)
            qs_i.append(xdr * gi + xdi * gr)
        y = fft_ops.irfft_tail_split(torch.stack(qs_r), torch.stack(qs_i), cfg.pad_len,
                                     cfg.frames_per_buffer)  # (2, ..., B, fpb)
        return y.movedim(0, -1)

    def render(self, signal: np.ndarray, positions) -> torch.Tensor:
        positions = torch.as_tensor(positions, dtype=torch.float32, device=self.device)
        xr, xi = self._forward(signal, int(positions.shape[0]))
        return self.render_spectra(xr, xi, positions).reshape(-1, 2)

    def localize(
        self,
        signal: np.ndarray,
        target,
        init_positions,
        steps: int = 300,
        lr: float = 2.0,
        optimize_r: bool = True,
        segment_blocks: int | None = None,
    ):
        """Recover per-block source positions from a binaural recording.

        target: (B*fpb, 2) rendered/recorded stereo of ``signal``.
        init_positions: (B, 3) starting guess.
        segment_blocks: None -> one grid candidate initializes every block
        (static or slowly-moving source); an int -> the grid search picks a
        winner per segment of that many blocks, so moving trajectories start
        each segment in the right basin.
        optimize_r=False pins every block's radius to the CALLER's
        init_positions values (grid candidates are evaluated at those
        per-block radii, and the Adam mask freezes them), fitting only the
        directions.
        Returns (fitted positions (B, 3) np.ndarray, loss history list);
        history[0] and history[-1] are fullband losses (start / best found),
        interior entries are the per-stage (lowpassed) descent losses.
        """
        if segment_blocks is not None and segment_blocks <= 0:
            raise ValueError(f"segment_blocks must be a positive int, got {segment_blocks}")
        t0 = time.perf_counter()
        fit = _Fit(self, signal, target, init_positions, optimize_r)
        b = fit.b
        t_setup = time.perf_counter()

        # Stage 1 — coarse grid init.  Waveform MSE is multimodal in
        # direction (ITD phase cycles, and an "attenuate by pushing the
        # source away" minimum), so a batched direction sweep picks the
        # right basin before any gradient step.
        azis = np.arange(0.0, 360.0, 10.0)
        eles = np.arange(-40.0, 91.0, 10.0)
        # with optimize_r=False the candidates' r is replaced by the
        # caller's per-block radii, so one dummy value suffices
        radii = np.array([0.25, 0.5, 1.0, 1.5, 2.5, 4.0]) if optimize_r else np.array([1.0])
        aa, ee, rr = np.meshgrid(azis, eles, radii, indexing="ij")
        cand = np.stack([aa.ravel(), ee.ravel(), rr.ravel()], axis=-1).astype(np.float32)
        gl_blocks = fit.grid(cand)
        seg = segment_blocks or b
        pos_np = np.empty((b, 3), np.float32)
        for s0 in range(0, b, seg):
            s1 = min(s0 + seg, b)
            pos_np[s0:s1] = cand[int(np.argmin(gl_blocks[:, s0:s1].mean(axis=1)))]
        if not optimize_r:
            pos_np[:, 2] = fit.pos0[:, 2].cpu().numpy()
        pos = torch.from_numpy(pos_np).to(self.device)
        t1 = time.perf_counter()

        # Stage 2 — coarse-to-fine gradient refinement (per-block positions):
        # heavy lowpass first (wide, smooth basin for r/ITD), full band last.
        # The best fullband-loss position ever visited is what's returned —
        # gradient stages can wander out of a good basin on hard signals.
        # One axis for the whole history: the FULLBAND loss.
        fit.best_pos, fit.best_loss = pos, fit.fullband(pos)
        fit.history.append(fit.best_loss)
        n2 = len(fit.history)
        pos = fit.descend(pos, [64, 16, 4, 1], steps, lr)
        n2 = len(fit.history) - n2
        t2 = time.perf_counter()

        # Stage 3 — direction re-grid at the fitted radius.  The coarse grid's
        # 10-degree spacing and sparse radii can strand stage 2 in an
        # interpolation-cell ripple; with r pinned to the fitted value a fine
        # direction sweep lands in the true basin, and a short full-band
        # polish converges.
        fine_az = np.arange(0.0, 360.0, 3.0)
        fine_el = np.arange(-40.0, 91.0, 3.0)
        fa, fe_ = np.meshgrid(fine_az, fine_el, indexing="ij")
        bp = fit.best_pos.cpu().numpy()
        pos_np = np.empty((b, 3), np.float32)
        gl2_cache: dict[float, tuple] = {}  # fine-grid losses per distinct r
        for s0 in range(0, b, seg):
            s1 = min(s0 + seg, b)
            r_fit = round(float(bp[s0:s1, 2].mean()), 6)
            if r_fit not in gl2_cache:
                cand2 = np.stack([fa.ravel(), fe_.ravel(), np.full(fa.size, r_fit)],
                                 axis=-1).astype(np.float32)
                gl2_cache[r_fit] = (cand2, fit.grid(cand2))
            cand2, gl2_all = gl2_cache[r_fit]
            pos_np[s0:s1] = cand2[int(np.argmin(gl2_all[:, s0:s1].mean(axis=1)))]
            pos_np[s0:s1, 2] = bp[s0:s1, 2]
        pos = torch.from_numpy(pos_np).to(self.device)
        fit.consider(pos)
        t3 = time.perf_counter()
        n4 = len(fit.history)
        fit.descend(pos, [4, 1], max(40, steps // 4), lr * 0.5)
        n4 = len(fit.history) - n4
        t4 = time.perf_counter()

        fit.history.append(fit.best_loss)
        self.timings = {"setup_s": t_setup - t0, "grid_s": t1 - t_setup,
                        "grid_candidates": len(cand), "descent_s": t2 - t1,
                        "descent_steps": n2, "fine_grid_s": t3 - t2,
                        "fine_grid_candidates": len(fa.ravel()) * len(gl2_cache),
                        "polish_s": t4 - t3, "polish_steps": n4}
        return fit.best_pos.cpu().numpy(), fit.history


class _Fit:
    """One ``localize`` call's state on the device: the forward planes, the
    target and its lowpassed copies, the caller's radii, the descent's
    history and the best fullband position found."""

    def __init__(self, r: DifferentiableRenderer, signal, target, init_positions,
                 optimize_r: bool):
        cfg, dev = r.config, r.device
        self.r = r
        self.pos0 = _f32(init_positions, dev)
        self.b = b = int(self.pos0.shape[0])
        self.xr, self.xi = r._forward(signal, b)
        self.tgt = _f32(target, dev).reshape(b, cfg.frames_per_buffer, 2)
        self.optimize_r = optimize_r
        self.mask = torch.tensor([1.0, 1.0, 1.0 if optimize_r else 0.0], device=dev)
        self._tgt_s: dict[int, torch.Tensor] = {}
        self.history: list[float] = []
        self.best_pos: torch.Tensor | None = None
        self.best_loss = float("inf")

    def target(self, width: int) -> torch.Tensor:
        if width not in self._tgt_s:
            self._tgt_s[width] = smooth(self.tgt, width)
        return self._tgt_s[width]

    def loss(self, pos: torch.Tensor, width: int) -> torch.Tensor:
        out = smooth(self.r.render_spectra(self.xr, self.xi, pos), width)
        return torch.mean((out - self.target(width)) ** 2) * LOSS_SCALE

    @torch.no_grad()
    def fullband(self, pos: torch.Tensor) -> float:
        return float(self.loss(pos, 1))

    def consider(self, pos: torch.Tensor) -> None:
        """Keep ``pos`` if its fullband loss is the best so far."""
        fl = self.fullband(pos)
        if fl < self.best_loss:
            self.best_pos, self.best_loss = pos.detach().clone(), fl

    @torch.no_grad()
    def grid(self, cand: np.ndarray) -> np.ndarray:
        """(C, 3) candidates -> (C, b) per-block wide-basin (width-64
        lowpassed) losses, each candidate held at every block, in chunks of
        GRID_CHUNK candidates; with optimize_r=False at the caller's radii."""
        tgt = self.target(64)
        out = []
        for c0 in range(0, len(cand), GRID_CHUNK):
            c = torch.tensor(cand[c0:c0 + GRID_CHUNK], device=self.xr.device)
            p = c[:, None, :].expand(-1, self.b, 3)
            if not self.optimize_r:
                p = torch.cat([p[..., :2], self.pos0[None, :, 2:3].expand(len(c), -1, -1)], -1)
            o = smooth(self.r.render_spectra(self.xr, self.xi, p), 64)
            out.append(((o - tgt) ** 2).mean(dim=(-2, -1)) * LOSS_SCALE)
        return torch.cat(out).cpu().numpy()

    def descend(self, pos: torch.Tensor, schedule, n_steps: int, rate: float) -> torch.Tensor:
        """Adam on the positions, a fresh optimizer per lowpass width, the
        gradient masked before each update; the loss before each update goes
        into the history, and every 10th position is considered for the
        best."""
        per = n_steps // len(schedule)
        p = pos.detach().clone().requires_grad_(True)
        for width in schedule:
            opt = torch.optim.Adam([p], lr=rate)
            for i in range(max(1, per)):
                opt.zero_grad()
                loss = self.loss(p, width)
                loss.backward()
                p.grad.mul_(self.mask)
                opt.step()
                self.history.append(loss.item())
                if i % 10 == 0 or i == per - 1:
                    self.consider(p)
        return p.detach()
