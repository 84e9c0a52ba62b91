"""Streaming engine: block processing with carried overlap-save state.
Counterpart of ``jefferson_tpu/engine/stream.py``, in two forms:

* ``render_scan`` computes what the JAX package's ``lax.scan`` over blocks
  computes (reference: Jefferson/src/Audio.cu:94-163, the realtime loop):
  blocks depend on each other only through the input history, so one
  forward over ``[zeros(history) | fed]`` and one launch of kernel row 8 per
  chunk of blocks give every block at once.

* ``StreamingSpatializer`` is the live block-at-a-time API, the analogue of
  the PortAudio callback path: set the position, push 128 samples, get 128
  stereo frames.  One block is one launch of launch A and row 8
  (``kernels/fused_spatializer.fused_forward_apply``) on the card; the
  history stays on the card between calls, and each block moves 128
  samples up and 256 floats down through pinned host buffers.

Both run on the card unless the caller asks for the CPU, where the
kernels' plain twins run, at every geometry the JAX package runs.  A
history of whole blocks takes the sliding forward in launch A; a history
of partial blocks (fpb 100 or 441 under pad 1024) takes the JAX package's
form: the forward DFT of each whole window (``ops/fft.rfft_split``) and the
distance planes in plain torch, then row 8's apply-only entry
(``kernels/fused_spatializer.fused_apply``) on those XD planes.  The JAX
package applies each filter to the plain forward and then the distance,
``(X·G)·D``; the port's steps apply the distance to the forward first,
``(X·D)·G``: the two differ in rounding only.  Every session on one device shares one copy of the filter
table per database (``_device_table``); PyTorch has no jit, so the JAX
package's shared jitted step has no counterpart.
"""

from __future__ import annotations

import functools
import threading
import weakref

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, EngineConfig
from ..hrtf.kemar import HRTFDatabase, round_half_away
from ..kernels.fused_spatializer import fused_apply, fused_forward_apply, kernel_planes
from ..ops import fft as fft_ops
from ..ops.filters import cmul, distance_factors_split, distance_phase_split
from ..trajectory.interpolation import interpolation_calculations
from ..trajectory.spatial import (
    cartesian_to_spherical, radius_from_cartesian, spherical_to_cartesian,
)
from .plan import fed_stream, make_plan
from .renderer import check_card_geometry, resolve_device

_F32 = np.float32

# Rows per render_scan launch: the XD scratch of a chunk is 2 x rows x 513
# floats, 67 MB at 16,384 rows, so the reference sweep (12,556 blocks) is
# one launch.
SCAN_CHUNK = 16384


def _stream_device(device, config: EngineConfig) -> torch.device:
    """The device the streaming forms run on; raises, before any launch, for
    a geometry the card cannot run (``check_card_geometry``)."""
    if torch.device(device).type == "cuda":
        check_card_geometry(config, "the streaming engine", "run it on the CPU")
    return resolve_device(device)


def _published(t: torch.Tensor) -> torch.Tensor:
    """``t`` once the stream that made it has finished: a tensor shared by
    sessions that each run on a CUDA stream of their own (the daemon's) is
    read there with no event to wait on."""
    if t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()
    return t


@functools.lru_cache(maxsize=None)
def _xf_flag(device: torch.device, on: bool) -> torch.Tensor:
    """The (1, 1) crossfade mask of one block, kept on ``device``."""
    return _published(torch.full((1, 1), float(on), dtype=torch.float32, device=device))


def _window_xd(windows, u_hi, u_lo, inv_frac, config: EngineConfig):
    """XD planes of (rows, pad_len) whole windows: their forward DFT times
    the distance planes of the (rows, 1) split, for a history of partial
    blocks, where the sliding forward does not apply."""
    xr, xi = fft_ops.rfft_split(windows, config.pad_len)
    dr, di = distance_factors_split(u_hi[:, 0], u_lo[:, 0], inv_frac[:, 0], config.num_bins)
    return cmul(xr, xi, dr, di)


def _block_step(table, hist, block, idx_new, w_new, idx_old, w_old, xf, u_hi, u_lo, inv_frac,
                *, config: EngineConfig, scratch=None):
    """One block through the interpolating pipeline: hist (history_len,),
    block (fpb,), brackets (1, 4), xf and the distance split (1, 1) ->
    ((2, fpb) [L; R], new hist).  ``scratch``: the (1, bins) XD planes
    launch A writes (a history of whole blocks)."""
    fpb = config.frames_per_buffer
    seg = torch.cat([hist, block])
    if config.history_len % fpb == 0:
        y = fused_forward_apply(table, seg, u_hi, u_lo, inv_frac, idx_old, w_old, idx_new, w_new,
                                xf, pad_len=config.pad_len, bins=config.num_bins, fpb=fpb,
                                scratch=scratch)
    else:
        xdr, xdi = _window_xd(seg[None], u_hi, u_lo, inv_frac, config)
        y = fused_apply(table, xdr, xdi, idx_old, w_old, idx_new, w_new, xf,
                        bins=config.num_bins, fpb=fpb)
    return y.view(2, fpb), seg[fpb:]


def _block_step_noxf(table, hist, block, idx_new, w_new, u_hi, u_lo, inv_frac,
                     *, config: EngineConfig, scratch=None):
    """The no-crossfade block step: the same launch with the new brackets on
    both sides and xf = 0.  Its output equals ``_block_step``'s with
    xf = 0 bit for bit (there out = y_old*0 + y_new*1 = y_new), the JAX
    package's contract for the live loop's held blocks."""
    return _block_step(table, hist, block, idx_new, w_new, idx_new, w_new,
                       _xf_flag(hist.device, False), u_hi, u_lo, inv_frac,
                       config=config, scratch=scratch)


_TABLE_CACHE: dict = {}
# One lock for the cache: sessions may start on several threads at once,
# and an unguarded miss would let two of them upload private tables.
_CACHE_LOCK = threading.Lock()


def _device_table(db: HRTFDatabase, device) -> torch.Tensor:
    """The full filter table of ``db`` on ``device``, one copy per
    (database, device) shared by every session and scan.  Keyed by id(db)
    with the database held weakly, so a dropped database releases it."""
    device = torch.device(device)
    with _CACHE_LOCK:
        key = (id(db), str(device))
        hit = _TABLE_CACHE.get(key)
        if hit is not None and hit[0]() is db:
            return hit[1]
        table = _published(kernel_planes(db, device))

        def _drop(_ref, _key=key):
            _TABLE_CACHE.pop(_key, None)

        _TABLE_CACHE[key] = (weakref.ref(db, _drop), table)
        return table


def render_scan(
    signal: np.ndarray,
    db: HRTFDatabase,
    positions,
    config: EngineConfig = DEFAULT_CONFIG,
    initial_old: tuple[float, float] | None = (0.0, 0.0),
    *,
    device="cuda",
    chunk_blocks: int = SCAN_CHUNK,
) -> np.ndarray:
    """Sequential render of the interpolating FD path -> (B*fpb, 2): the
    JAX ``lax.scan`` with its zero initial history, one launch of row 8 per
    chunk of ``chunk_blocks`` blocks (after the chunk's window transforms
    in plain torch at a history of partial blocks)."""
    if chunk_blocks < 1:
        raise ValueError(f"chunk_blocks ({chunk_blocks}) must be positive")
    device = _stream_device(device, config)
    plan = make_plan(np.asarray(positions), config, initial_old)
    fpb, hist = config.frames_per_buffer, config.history_len
    b = plan.num_blocks
    fed = fed_stream(signal, b, config)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    stream = put(np.concatenate([np.zeros(hist, _F32), fed]))
    col = lambda a: put(a.astype(_F32)[:, None])
    dist = [col(a) for a in (plan.u_hi, plan.u_lo, plan.inv_frac)]
    brackets = [put(a) for a in (plan.idx_old, plan.w_old, plan.idx_new, plan.w_new)]
    xf = col(plan.xfade)
    table = _device_table(db, device)
    out = torch.empty((b, 2 * fpb), dtype=torch.float32, device=device)
    for start in range(0, b, chunk_blocks):
        sl = slice(start, min(start + chunk_blocks, b))
        if config.history_len % fpb == 0:
            out[sl] = fused_forward_apply(
                table, stream[start * fpb : sl.stop * fpb + hist], *(a[sl] for a in dist),
                *(a[sl] for a in brackets), xf[sl],
                pad_len=config.pad_len, bins=config.num_bins, fpb=fpb)
        else:
            windows = stream[start * fpb : sl.stop * fpb + hist].unfold(0, config.pad_len, fpb)
            xdr, xdi = _window_xd(windows, *(a[sl] for a in dist), config)
            out[sl] = fused_apply(table, xdr, xdi, *(a[sl] for a in brackets), xf[sl],
                                  bins=config.num_bins, fpb=fpb)
    return out.view(b, 2, fpb).permute(0, 2, 1).reshape(b * fpb, 2).cpu().numpy()


class StreamingSpatializer:
    """Live block-at-a-time spatializer (the PortAudio-callback analogue).

    Mirrors the reference's mutable SoundSource state machine (position,
    old-position crossfade trigger, overlap-save history, wrapping playhead
    when fed from a buffer) with one step per block on ``device``, the card
    unless the caller asks for the CPU.
    """

    _CACHE_CAP = 4096  # bound the per-position memos for long-lived sessions

    def __init__(
        self,
        db: HRTFDatabase,
        config: EngineConfig | None = None,
        pipeline_latency: int = 0,
        *,
        device="cuda",
    ):
        """``pipeline_latency=1`` reproduces the reference GPU path's timing:
        each call emits the *previous* block's result (silence first) while
        the current block is processed — the callback/enqueue overlap of
        reference: Jefferson/src/Audio.cu:104-117.  0 (default) is the
        synchronous CPU-path timing."""
        self.db = db
        self.config = config or db.config
        self.device = _stream_device(device, self.config)
        self.pipeline_latency = pipeline_latency
        self._pending: list[np.ndarray] = []
        cfg = self.config
        self._table = _device_table(db, self.device)  # shared per (db, device)
        self._hist = torch.zeros(cfg.history_len, dtype=torch.float32, device=self.device)
        self._scratch = tuple(torch.empty((1, cfg.num_bins), dtype=torch.float32,
                                          device=self.device) for _ in range(2))
        # pinned host buffers for the block's samples up and its output down
        pinned = self.device.type == "cuda"
        fpb = cfg.frames_per_buffer
        self._up = torch.empty(fpb, dtype=torch.float32, pin_memory=pinned) if pinned else None
        self._down = torch.empty((2, fpb), dtype=torch.float32, pin_memory=pinned) if pinned else None
        # reference constructor state (Jefferson/src/SoundSource.cu:3-16)
        self.azi = _F32(0.0)
        self.ele = _F32(0.0)
        self.r = _F32(0.5)
        self.old_azi = self.azi
        self.old_ele = self.ele
        # raw cartesian coordinates, set only by set_position_cartesian: the
        # oracle derives the distance factor from the raw xyz (reference
        # update_from_cartesian); the rounded angles would move the radius
        # by an ulp
        self._coords: tuple[float, float, float] | None = None
        self.buf: np.ndarray | None = None
        self.count = 0
        self.clipping = False
        self.crossfades = 0  # blocks whose position changed (xfade fired)
        # per-position memos of device operands: live callers hold a
        # position for many blocks, so the interpolation and distance setup
        # (pure functions of azi/ele/r) is computed and uploaded once
        self._interp_cache: dict[tuple, tuple] = {}
        self._dist_cache: dict[tuple, tuple] = {}

    def set_position(self, azi=None, ele=None, r=None) -> None:
        if azi is not None:
            self.azi = _F32(round_half_away(_F32(azi)))
        if ele is not None:
            self.ele = _F32(round_half_away(_F32(ele)))
        if r is not None:
            self.r = _F32(r)
        self._coords = None  # spherical-driven: radius via the xyz roundtrip

    def set_position_cartesian(self, xyz) -> None:
        xyz = np.asarray(xyz, dtype=_F32)
        azi, ele, r = cartesian_to_spherical(xyz)
        self.azi, self.ele, self.r = _F32(azi), _F32(ele), _F32(r)
        # keep the RAW coordinates for the distance factor, like the oracle
        self._coords = (float(xyz[0]), float(xyz[1]), float(xyz[2]))

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _interp(self, ele, azi):
        """(1, 4) bracket ids and weights of a position, on the device."""
        key = (float(ele), float(azi))
        hit = self._interp_cache.get(key)
        if hit is None:
            if len(self._interp_cache) >= self._CACHE_CAP:
                self._interp_cache.clear()
            c = interpolation_calculations(ele, azi)
            hit = (self._put(c.indices.astype(np.int32)), self._put(c.weights.astype(_F32)))
            self._interp_cache[key] = hit
        return hit

    def _distance_current(self):
        """(1, 1) distance split (u_hi, u_lo, inv_frac) of the CURRENT
        position, on the device.

        Spherical-driven positions reconstruct coordinates from the rounded
        angles (the offline planner's semantics); cartesian-driven positions
        use the raw xyz like the oracle's update_from_cartesian — the keys
        are tagged so the two conventions never collide in the memo."""
        if self._coords is not None:
            key = ("c", *self._coords)
        else:
            key = ("s", float(self.azi), float(self.ele), float(self.r))
        hit = self._dist_cache.get(key)
        if hit is None:
            if len(self._dist_cache) >= self._CACHE_CAP:
                # a continuously varying radius would otherwise grow this
                # without bound
                self._dist_cache.clear()
            cfg = self.config
            if key[0] == "c":
                coords = np.asarray(key[1:], dtype=_F32)
            else:
                coords = spherical_to_cartesian(self.azi, self.ele, self.r)
            scaled_r = np.float32(radius_from_cartesian(coords) / _F32(cfg.distance_scale))
            split = distance_phase_split(cfg.fsvs, scaled_r[None], cfg.num_bins)
            hit = tuple(self._put(a.reshape(1, 1)) for a in split)
            self._dist_cache[key] = hit
        return hit

    def _upload(self, block: np.ndarray) -> torch.Tensor:
        if self._up is None:
            return torch.from_numpy(block)
        # the previous block's copy from this buffer ended at its download
        self._up.numpy()[:] = block
        return self._up.to(self.device, non_blocking=True)

    def _download(self, y: torch.Tensor) -> np.ndarray:
        """(2, fpb) [L; R] on the device -> a new (fpb, 2) host array."""
        if self._down is None:
            return y.numpy().T.copy()
        self._down.copy_(y, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return self._down.numpy().T.copy()

    def prime(self) -> None:
        """Build the kernels and warm the block step without mutating
        streaming state.

        Realtime callers (rt.playout) invoke this before opening the device
        stream so the first audible block pays neither the build nor a
        host-cache miss — the analogue of the reference doing all
        CUDA/cuFFT setup in the constructor before PortAudio starts
        (Jefferson/src/GPUSoundSource.cu:17-71)."""
        cfg = self.config
        idx, w = self._interp(self.ele, self.azi)
        dist = self._distance_current()
        zeros = self._upload(np.zeros(cfg.frames_per_buffer, _F32))
        out, _ = _block_step(self._table, self._hist, zeros, idx, w, idx, w,
                             _xf_flag(self.device, False), *dist, config=cfg,
                             scratch=self._scratch)
        self._download(out)
        out, _ = _block_step_noxf(self._table, self._hist, zeros, idx, w, *dist, config=cfg,
                                  scratch=self._scratch)
        self._download(out)

    def process_block(self, block: np.ndarray) -> np.ndarray:
        """Push frames_per_buffer mono samples -> (fpb, 2) float32 stereo."""
        cfg = self.config
        block = np.asarray(block, dtype=_F32)
        if block.shape != (cfg.frames_per_buffer,):
            raise ValueError(f"block must be ({cfg.frames_per_buffer},), got {block.shape}")
        idx_n, w_n = self._interp(self.ele, self.azi)
        xfade = bool(self.old_azi != self.azi or self.old_ele != self.ele)
        self.crossfades += int(xfade)
        # keyed on the full position: the float32 xyz roundtrip makes the
        # effective radius minutely angle-dependent (reference semantics)
        dist = self._distance_current()
        blk = self._upload(block)
        if xfade:
            idx_o, w_o = self._interp(self.old_ele, self.old_azi)
            out, self._hist = _block_step(
                self._table, self._hist, blk, idx_n, w_n, idx_o, w_o,
                _xf_flag(self.device, True), *dist, config=cfg, scratch=self._scratch)
        else:
            # steady state (most live blocks): bit-identical to the
            # crossfade form with xf = 0
            out, self._hist = _block_step_noxf(
                self._table, self._hist, blk, idx_n, w_n, *dist, config=cfg,
                scratch=self._scratch)
        self.old_azi, self.old_ele = self.azi, self.ele
        out = self._download(out)
        if np.any(np.abs(out) > 1.0):
            self.clipping = True  # reference: clipping alert (Audio.cu:111-113)
        if self.pipeline_latency:
            self._pending.append(out)
            if len(self._pending) > self.pipeline_latency:
                return self._pending.pop(0)
            return np.zeros_like(out)
        return out

    def next_block(self) -> np.ndarray:
        """Advance the wrapping playback buffer (set ``self.buf`` first) and
        return the next raw mono block, a copy — THE playhead: the rt loop
        feeds through it rather than re-deriving the `% length` arithmetic."""
        fpb = self.config.frames_per_buffer
        if self.buf is None:
            raise ValueError(
                "set .buf (the wrapping playback buffer) before pulling blocks"
            )
        length = len(self.buf)
        if length == 0:
            raise ValueError("playback buffer is empty")
        if self.count + fpb < length:
            # copy: the wrap branch's fancy index below is a copy, and the
            # playhead must not hand out live views of the buffer
            blk = self.buf[self.count : self.count + fpb].copy()
            self.count += fpb
        else:
            # modular wrap (the reference's `% length` playhead,
            # Audio.cu:121-139, generalized): buffers shorter than one
            # block tile as many times as needed, like fed_stream
            blk = self.buf[(self.count + np.arange(fpb)) % length]
            self.count = (self.count + fpb) % length
        return blk

    def process_next(self) -> np.ndarray:
        """Pull the next block from the wrapping playback buffer (set
        ``self.buf`` first), like the reference's callback feed."""
        return self.process_block(self.next_block())
