"""Per-block source positions: a copy of the trajectory classes of
``jefferson_tpu/trajectory/trajectory.py`` that the port and its chip smoke
use.  A trajectory is sampled once per block; the plan applies the
reference's degree rounding and crossfade-on-change semantics."""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import DEFAULT_CONFIG, EngineConfig


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
