"""Cartesian <-> spherical with the reference's rounding: a copy of
``jefferson_tpu/trajectory/spatial.py`` (reference:
Jefferson/src/SoundSource.cu:20-54).  Degrees; azimuth 0 is straight ahead
(-z), increasing clockwise seen from above; elevation positive upward; both
rounded to whole degrees half away from zero."""

from __future__ import annotations

import numpy as np

from ..hrtf.kemar import round_half_away


def cartesian_to_spherical(xyz: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(..., 3) cartesian -> (azi_deg, ele_deg, r), angles rounded, in the
    reference's float32 arithmetic (SoundSource.cu:20-36)."""
    p = np.asarray(xyz, dtype=np.float32)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = np.sqrt(x * x + z * z + y * y).astype(np.float32)
    horiz_r = np.sqrt(x * x + z * z).astype(np.float32)
    ele = (np.arctan2(y, horiz_r) * np.float32(180.0 / np.pi)).astype(np.float32)
    with np.errstate(invalid="ignore"):
        azi = (np.arctan2(-x / r, -z / r) * np.float32(180.0 / np.pi)).astype(np.float32)
    azi = np.where(azi < 0.0, azi + np.float32(360.0), azi)
    azi = np.where(r == 0.0, np.float32(0.0), azi)  # 0/0 at the origin
    ele = np.where(r == 0.0, np.float32(0.0), ele)
    return (
        round_half_away(azi).astype(np.float32),
        round_half_away(ele).astype(np.float32),
        r,
    )


def spherical_to_cartesian(azi_deg, ele_deg, r) -> np.ndarray:
    """(azi, ele, r) -> (..., 3) cartesian after rounding the angles, in
    float32 (SoundSource.cu:41-54).  Like the reference, y is r*sin(ele)
    and the horizontal components carry no cos(ele)."""
    azi = round_half_away(np.asarray(azi_deg, dtype=np.float32)).astype(np.float32)
    ele = round_half_away(np.asarray(ele_deg, dtype=np.float32)).astype(np.float32)
    r = np.asarray(r, dtype=np.float32)
    deg = np.float32(np.pi / 180.0)
    x = r * np.sin(azi * deg)
    z = r * -np.cos(azi * deg)
    y = r * np.sin(ele * deg)
    return np.stack([x, y, z], axis=-1).astype(np.float32)


def radius_from_cartesian(xyz: np.ndarray) -> np.ndarray:
    """|coordinates| in float32, the radius of the distance factor
    (reference: Jefferson/src/CPUSoundSource.cpp:35-39)."""
    p = np.asarray(xyz, dtype=np.float32)
    return np.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2 + p[..., 2] ** 2).astype(np.float32)
