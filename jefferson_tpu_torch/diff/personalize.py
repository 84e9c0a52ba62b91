"""HRTF personalization: fit a listener's filter table from sparse
measurements, on torch autograd.

Counterpart of ``jefferson_tpu/diff/personalize.py``.  Generic HRTF sets
(KEMAR) localize poorly for individual listeners; measuring a full
710-direction set per listener is impractical, but a handful of directions
is easy.  Because the renderer interpolates the table smoothly
(``diff.render.smooth_coeffs``), fitting is a differentiable inverse
problem: adjust the full table so interpolation reproduces the measured
HRIR spectra, with azimuth-ring smoothness and an anchor to the starting
set so sparse data generalizes instead of spiking.  ``optax.adam`` becomes
``torch.optim.Adam``.

The gather's backward scatters into filter rows that several measured
directions share, in an order that depends on the device, so a fit on the
card and one on the CPU agree to a tolerance, not bit for bit.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.fft
import torch

from ..config import EngineConfig
from ..engine.renderer import resolve_device
from ..hrtf.kemar import AZIMUTH_COUNTS, AZIMUTH_OFFSET, NUM_ELEV, NUM_HRTF, HRTFDatabase
from .render import smooth_coeffs


def _azimuth_successors() -> np.ndarray:
    """succ[i] = next azimuth grid index within i's elevation ring (wraps)."""
    succ = np.empty(NUM_HRTF, np.int32)
    for e in range(NUM_ELEV):
        o, n = int(AZIMUTH_OFFSET[e]), int(AZIMUTH_COUNTS[e])
        succ[o : o + n] = o + (np.arange(n) + 1) % n
    return succ


def _measured_taps(meas: list, config: EngineConfig) -> np.ndarray:
    """The measurements' HRIRs as (M, 2, pad_len) float32, each cut to
    ``hrtf_len`` taps: the engine's filter class IS hrtf_len taps, so the fit
    runs against the truncated measurement (fitting the full-tap spectrum and
    truncating only at rebuild would silently discard what was just fit),
    with a warning when the dropped tail carries energy."""
    taps = np.zeros((len(meas), 2, config.pad_len), np.float32)
    for j, (_, _, h) in enumerate(meas):
        h = np.asarray(h, np.float32)
        if h.ndim != 2 or h.shape[0] != 2:
            raise ValueError(f"measurement {j}: hrir must be (2, taps), got {h.shape}")
        if h.shape[1] > config.hrtf_len:
            tail = float(np.sum(h[:, config.hrtf_len :] ** 2))
            tot = float(np.sum(h**2)) or 1.0
            if tail / tot > 1e-4:
                warnings.warn(
                    f"measurement {j}: {h.shape[1]} taps truncated to "
                    f"hrtf_len={config.hrtf_len} ({100 * tail / tot:.2f}% of "
                    f"the energy dropped) — engine filters are hrtf_len taps"
                )
            h = h[:, : config.hrtf_len]
        taps[j, :, : h.shape[1]] = h
    return taps


def fit_database(
    measurements,
    db0: HRTFDatabase,
    config: EngineConfig | None = None,
    steps: int = 400,
    lr: float = 0.05,
    smooth: float = 3.0,
    anchor: float = 0.005,
    device="cuda",
):
    """Fit a personalized HRTFDatabase from sparse measured HRIRs.

    measurements: iterable of (azi_deg, ele_deg, hrir) with hrir (2, taps)
    float — the listener's measured impulse-response pair at that direction.
    db0: the starting (generic) database.
    smooth: weight of the azimuth-ring smoothness penalty on the correction
    field (spreads measured deviations to unmeasured directions).
    anchor: weight of the pull toward zero correction (prevents drift).
    device: where the fit runs; "cuda" without a card raises.

    Parameterization: a multiplicative complex correction field c per
    filter/ear/bin, S = S0 * (1 + c), initialized at zero.  Individual
    deviations from a generic set are dominated by smooth spectral-gain
    differences (ear shape EQ), which are *constant or slowly varying
    across direction* in c — so ring smoothing propagates sparse
    measurements across the whole grid instead of fighting the table's own
    directional structure.

    Returns (HRTFDatabase, loss_history).  The fitted taps are rebuilt from
    the optimized spectra (truncated to hrtf_len) so engine/oracle
    consistency (spectra == rfft(hrirs)) is preserved.
    """
    device = resolve_device(device)
    config = config or db0.config
    meas = list(measurements)
    if not meas:
        raise ValueError("need at least one measurement")
    azi = np.array([m[0] for m in meas], np.float32)
    ele = np.array([m[1] for m in meas], np.float32)
    target = scipy.fft.rfft(_measured_taps(meas, config), axis=-1)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    t_r, t_i = put(np.real(target)), put(np.imag(target))  # (M, 2, bins)

    idx, w = smooth_coeffs(put(azi), put(ele))  # (M, 4) each
    succ = torch.from_numpy(_azimuth_successors()).long().to(device)
    s0_r, s0_i = put(np.real(db0.spectra)), put(np.imag(db0.spectra))  # (N, 2, bins)

    def interp(tab):  # (N, 2, bins) -> (M, 2, bins)
        g = w[:, 0, None, None] * tab[idx[:, 0]]
        for k in range(1, 4):
            g = g + w[:, k, None, None] * tab[idx[:, k]]
        return g

    def corrected(cr, ci):  # S = S0 * (1 + cr + i*ci)
        sr = s0_r * (1.0 + cr) - s0_i * ci
        si = s0_r * ci + s0_i * (1.0 + cr)
        return sr, si

    def loss_fn(cr, ci):
        sr, si = corrected(cr, ci)
        data = torch.mean((interp(sr) - t_r) ** 2) + torch.mean((interp(si) - t_i) ** 2)
        ring = torch.mean((cr - cr[succ]) ** 2) + torch.mean((ci - ci[succ]) ** 2)
        pull = torch.mean(cr**2) + torch.mean(ci**2)
        return data + smooth * ring + anchor * pull

    cr = torch.zeros_like(s0_r, requires_grad=True)
    ci = torch.zeros_like(s0_i, requires_grad=True)
    opt = torch.optim.Adam([cr, ci], lr=lr)
    history = []
    for _ in range(steps):
        opt.zero_grad()
        loss = loss_fn(cr, ci)
        loss.backward()
        opt.step()
        history.append(loss.item())

    with torch.no_grad():
        sr, si = (p.cpu().numpy() for p in corrected(cr, ci))
    spectra = (sr + 1j * si).astype(np.complex64)
    hrirs = scipy.fft.irfft(spectra, n=config.pad_len, axis=-1)
    fitted = HRTFDatabase.from_hrirs(
        hrirs[:, :, : config.hrtf_len].astype(np.float32),
        config,
        source=f"personalized:{db0.source}",
    )
    return fitted, history
