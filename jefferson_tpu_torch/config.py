"""Engine configuration: a copy of ``jefferson_tpu/config.py``.

The reference fixes block size, HRIR length, FFT length and sample rate at
compile time (reference: Jefferson/src/Universal.cuh:1-34); here they are a
frozen dataclass, read as constants by the renderers.
``tests/test_torch_hosts.py`` pins the copy to the original.
"""

from __future__ import annotations

import dataclasses
import enum
import math


class ProcessType(enum.IntEnum):
    """Processing pipeline selector, with the integer values of the
    reference's ``-t`` flag (reference: Jefferson/src/Universal.cuh:25-32,
    Jefferson/src/main.cu:22-58)."""

    TPU_FD_COMPLEX = 0   # interpolating frequency-domain engine (flagship)
    TPU_FD_BASIC = 1     # nearest-HRTF frequency-domain engine
    TPU_TD = 2           # time-domain convolution engine
    CPU_FD_COMPLEX = 3   # NumPy oracle, interpolating
    CPU_FD_BASIC = 4     # NumPy oracle, nearest-HRTF
    CPU_TD = 5           # NumPy oracle, time-domain

    @property
    def is_oracle(self) -> bool:
        return self >= ProcessType.CPU_FD_COMPLEX

    @property
    def is_interpolating(self) -> bool:
        return self in (ProcessType.TPU_FD_COMPLEX, ProcessType.CPU_FD_COMPLEX)


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """All DSP constants of the engine; the defaults are the reference's
    (reference: Jefferson/src/Universal.cuh:4-13, Jefferson/src/main.cuh:16)."""

    sample_rate: int = 44_100
    frames_per_buffer: int = 128      # samples per streaming block
    hrtf_len: int = 512               # HRIR taps (full KEMAR set)
    num_hrtf: int = 710               # filters in the KEMAR grid
    speed_of_sound: float = 343.0     # m/s, used by the distance factor
    distance_scale: float = 5.0       # reference divides r by 5 (CPUSoundSource.cpp:40)
    # reference SoundSource gain (SoundSource.cu:6); only the time-domain
    # path applies it
    source_gain: float = 0.99074

    @property
    def pad_len(self) -> int:
        """FFT length: next pow2 of (block + hrtf_len - 1); 1024 by default."""
        return _next_pow2(self.frames_per_buffer + self.hrtf_len - 1)

    @property
    def num_bins(self) -> int:
        """R2C half-spectrum size (513 by default)."""
        return self.pad_len // 2 + 1

    @property
    def history_len(self) -> int:
        """Overlap-save history carried between blocks (896 by default)."""
        return self.pad_len - self.frames_per_buffer

    @property
    def block_duration(self) -> float:
        """Seconds of audio per block (~2.9 ms by default)."""
        return self.frames_per_buffer / self.sample_rate

    @property
    def fsvs(self) -> float:
        """fs / speed-of-sound factor of the distance cue (~128.57)."""
        return self.sample_rate / self.speed_of_sound

    def __post_init__(self) -> None:
        if self.frames_per_buffer < 2 or self.hrtf_len <= 0:
            # every crossfade ramp divides by (fpb - 1)
            raise ValueError("frames_per_buffer must be >= 2 and hrtf_len positive")
        if math.log2(self.pad_len) != int(math.log2(self.pad_len)):
            raise AssertionError("pad_len must be a power of two")


DEFAULT_CONFIG = EngineConfig()
