"""Per-block source positions: a copy of the trajectory classes of
``jefferson_tpu/trajectory/trajectory.py``, each ``sample()`` pinned bit for
bit to the original by ``tests/test_torch_trajectory.py``.  A trajectory is
sampled once per block; the plan applies the reference's degree rounding
and crossfade-on-change semantics."""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from ..config import DEFAULT_CONFIG, EngineConfig
from .spatial import cartesian_to_spherical


class Trajectory:
    """Base: sample per-block (azi_deg, ele_deg, r) positions."""

    def sample(self, num_blocks: int, config: EngineConfig = DEFAULT_CONFIG) -> np.ndarray:
        raise NotImplementedError

    def _times(self, num_blocks: int, config: EngineConfig) -> np.ndarray:
        """Start time of each block in seconds."""
        return np.arange(num_blocks) * config.block_duration

    @staticmethod
    def _wrap_azi(azi: np.ndarray) -> np.ndarray:
        """Wrap negative azimuths into [0, 360), the reference's own
        ``if azi < 0: azi += 360`` (SoundSource.cu:28-33); values >= 360 are
        left alone, as in the original."""
        azi = np.asarray(azi, dtype=np.float64)
        return np.where(azi < 0, azi % 360.0, azi)


@dataclasses.dataclass
class StaticPosition(Trajectory):
    """A fixed source."""

    azi: float = 0.0
    ele: float = 0.0
    r: float = 0.5

    def sample(self, num_blocks, config=DEFAULT_CONFIG):
        out = np.empty((num_blocks, 3), dtype=np.float64)
        out[:] = (self.azi, self.ele, self.r)
        out[:, 0] = self._wrap_azi(out[:, 0])
        return out


@dataclasses.dataclass
class PositionEvents(Trajectory):
    """Piecewise-constant position changes at given times (the reference's
    DEBUGMODE-2 scripted sequence as data, reference:
    Jefferson/src/main.cu:101-148).

    events: sequence of (time_sec, azi, ele, r); a position holds until the
    next event, and a leading (0.0, ...) event sets the initial position.
    """

    events: Sequence[tuple[float, float, float, float]]

    def sample(self, num_blocks, config=DEFAULT_CONFIG):
        ev = sorted(self.events, key=lambda e: e[0])
        if not ev:
            raise ValueError("PositionEvents needs at least one event")
        t = self._times(num_blocks, config)
        times = np.array([e[0] for e in ev])
        vals = np.array([[e[1], e[2], e[3]] for e in ev], dtype=np.float64)
        idx = np.clip(np.searchsorted(times, t, side="right") - 1, 0, len(ev) - 1)
        out = vals[idx]
        out[:, 0] = self._wrap_azi(out[:, 0])
        return out


@dataclasses.dataclass
class CircularOrbit(Trajectory):
    """A source orbiting the listener at constant elevation and radius."""

    period_s: float = 8.0
    ele: float = 0.0
    r: float = 1.0
    start_azi: float = 0.0
    direction: int = 1  # +1 clockwise (increasing azimuth)

    def sample(self, num_blocks, config=DEFAULT_CONFIG):
        if not self.period_s > 0:
            raise ValueError(f"period_s must be > 0, got {self.period_s}")
        t = self._times(num_blocks, config)
        azi = (self.start_azi + self.direction * 360.0 * t / self.period_s) % 360.0
        out = np.empty((num_blocks, 3), dtype=np.float64)
        out[:, 0] = azi
        out[:, 1] = self.ele
        out[:, 2] = self.r
        return out


def _cartesian_positions(xyz: np.ndarray) -> np.ndarray:
    """Raw xyz samples -> planner (azi, ele, r) with the cartesian drive's
    distance semantics.

    The planner rebuilds coordinates through the reference's spherical to
    cartesian conversion, which has no cos(ele) on the horizontal
    components, so its distance radius is r*sqrt(1 + sin^2(ele_rounded)),
    not the true |xyz| that the reference's cartesian update keeps.  A
    cartesian trajectory is that drive offline, so r is divided by the
    factor first and the planner's round trip lands on |xyz| (up to
    float32)."""
    azi, ele, r = cartesian_to_spherical(xyz)
    quirk = np.sqrt(1.0 + np.sin(np.deg2rad(ele.astype(np.float64))) ** 2)
    return np.stack([azi, ele, r / quirk], axis=-1).astype(np.float64)


@dataclasses.dataclass
class LinearPath(Trajectory):
    """Straight-line cartesian flyby from start_xyz to end_xyz over
    duration_s, holding the end point afterwards, through the reference's
    xyz -> spherical conversion and its rounding (reference:
    Jefferson/src/SoundSource.cu:20-36), with the cartesian drive's radius
    (``_cartesian_positions``)."""

    start_xyz: tuple[float, float, float]
    end_xyz: tuple[float, float, float]
    duration_s: float

    def sample(self, num_blocks, config=DEFAULT_CONFIG):
        t = self._times(num_blocks, config)
        a = np.clip(t / max(self.duration_s, 1e-9), 0.0, 1.0)[:, None]
        xyz = (1 - a) * np.asarray(self.start_xyz) + a * np.asarray(self.end_xyz)
        return _cartesian_positions(xyz)


@dataclasses.dataclass
class CartesianFunction(Trajectory):
    """Any xyz(t) callable -> spherical through the reference conversion,
    with the cartesian drive's radius (``_cartesian_positions``)."""

    fn: Callable[[np.ndarray], np.ndarray]  # (B,) times -> (B, 3) xyz

    def sample(self, num_blocks, config=DEFAULT_CONFIG):
        t = self._times(num_blocks, config)
        xyz = np.asarray(self.fn(t), dtype=np.float64)
        return _cartesian_positions(xyz)


@dataclasses.dataclass
class AzimuthSweep(Trajectory):
    """The reference's benchmarkTesting workload: hold a position for
    ``blocks_per_step`` blocks, then step azimuth by ``step_deg``, for
    ``num_steps`` steps (reference: Jefferson/src/precision_test.cu:2093-2148)."""

    start_azi: float = 0.0
    ele: float = 0.0
    r: float = 0.5
    step_deg: float = 5.0
    blocks_per_step: int = 172
    num_steps: int = 72

    @property
    def total_blocks(self) -> int:
        return self.blocks_per_step * (self.num_steps + 1)

    def sample(self, num_blocks, config=DEFAULT_CONFIG):
        steps = np.arange(num_blocks) // self.blocks_per_step
        azi = (self.start_azi + steps * self.step_deg) % 360.0
        out = np.empty((num_blocks, 3), dtype=np.float64)
        out[:, 0] = azi
        out[:, 1] = self.ele
        out[:, 2] = self.r
        return out
