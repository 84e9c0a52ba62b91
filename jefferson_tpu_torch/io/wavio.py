"""WAV codec (no libsndfile dependency): a copy of
``jefferson_tpu/io/wavio.py``.  Float32 reads and float32 PCM writes run
the port's host library (``native/``) where the JAX module runs its native
extension; ``_read_wav_numpy`` and ``_encode_numpy`` are the plain NumPy
forms, which ``tests/test_torch_native.py`` pins the library to.

The reference links libsndfile for all file I/O (reference:
Jefferson/src/cudaPart.cu:21-63 reads, Jefferson/src/Audio.cu:161 writes
24-bit PCM blocks).  This module is the port's equivalent: PCM 8/16/24/32
and IEEE-float 32/64 readers, PCM16/24/32 + float32 writers, a
block-streaming writer for incremental renders (the live loop's output),
and the stereo->mono downmix the reference applies on read.

Float conversion matches libsndfile's convention: PCM samples are scaled by
1 / 2^(bits-1) on read and 2^(bits-1) on write.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

from .. import native

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


@dataclasses.dataclass
class WavInfo:
    sample_rate: int
    channels: int
    frames: int
    bits: int
    float_format: bool


def _parse_chunks(data: bytes):
    if len(data) < 12 or data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    chunks = {}
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        body_start = pos + 8
        body_end = min(body_start + size, len(data))
        if cid not in chunks:  # keep first occurrence
            chunks[cid] = (body_start, body_end)
        pos = body_start + size + (size & 1)
    return chunks


def _decode_fmt(data: bytes, start: int, end: int):
    if end - start < 16:
        # without this, a short fmt chunk either parses the NEXT chunk's
        # bytes as channels/rate/bits (garbage audio, no error) or dies in
        # struct.error at EOF
        raise ValueError(f"truncated fmt chunk ({end - start} bytes, need 16)")
    fmt_tag, channels, sample_rate, _, _, bits = struct.unpack_from(
        "<HHIIHH", data, start
    )
    if fmt_tag == _WAVE_FORMAT_EXTENSIBLE:
        if end - start < 40:
            raise ValueError("truncated WAVE_FORMAT_EXTENSIBLE fmt chunk")
        # The true format tag is the first two bytes of the SubFormat GUID.
        fmt_tag = struct.unpack_from("<H", data, start + 24)[0]
    return fmt_tag, channels, sample_rate, bits


def read_wav_info(path: str | Path) -> WavInfo:
    data = Path(path).read_bytes()
    chunks = _parse_chunks(data)
    if b"fmt " not in chunks or b"data" not in chunks:
        raise ValueError(f"{path}: missing fmt/data chunk")
    fmt_tag, channels, sample_rate, bits = _decode_fmt(data, *chunks[b"fmt "])
    dstart, dend = chunks[b"data"]
    bytes_per_frame = channels * (bits // 8)
    if bytes_per_frame == 0:
        raise ValueError(f"{path}: malformed fmt chunk (channels={channels}, bits={bits})")
    frames = (dend - dstart) // bytes_per_frame
    return WavInfo(sample_rate, channels, frames, bits, fmt_tag == _WAVE_FORMAT_IEEE_FLOAT)


def read_wav(path: str | Path, dtype=np.float32) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (samples[frames, channels] in ``dtype``, sample_rate).

    PCM data is normalized to [-1, 1) by 1/2^(bits-1), matching libsndfile's
    ``sf_read_float`` used throughout the reference.  A float32 read decodes
    in the host library; other dtypes keep the NumPy decoder, whose float64
    intermediate keeps mantissa bits a float32 decode would lose.
    """
    return _read(path, dtype, native_float32=True)


def _read_wav_numpy(path: str | Path, dtype=np.float32) -> tuple[np.ndarray, int]:
    """The plain form of ``read_wav``: the NumPy decoder at every dtype."""
    return _read(path, dtype, native_float32=False)


def _read(path, dtype, native_float32: bool):
    data = Path(path).read_bytes()
    # the header is validated here on every path, so a malformed file fails
    # the same way in either decoder
    chunks = _parse_chunks(data)
    if b"fmt " not in chunks or b"data" not in chunks:
        raise ValueError(f"{path}: missing fmt/data chunk")
    fmt_tag, channels, sample_rate, bits = _decode_fmt(data, *chunks[b"fmt "])
    if channels == 0:
        raise ValueError(f"{path}: malformed fmt chunk (channels=0)")
    if fmt_tag not in (_WAVE_FORMAT_PCM, _WAVE_FORMAT_IEEE_FLOAT):
        raise ValueError(f"unsupported WAVE format tag 0x{fmt_tag:04x}")
    if native_float32 and np.dtype(dtype) == np.float32:
        return native.decode_wav(data)
    dstart, dend = chunks[b"data"]
    raw = data[dstart:dend]

    def _trim(buf, itemsize):
        # tolerate truncated data chunks (partial download / crashed
        # writer) like the 24-bit path does
        return buf[: len(buf) - (len(buf) % itemsize)]

    if fmt_tag == _WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            x = np.frombuffer(_trim(raw, 4), dtype="<f4").astype(dtype)
        elif bits == 64:
            x = np.frombuffer(_trim(raw, 8), dtype="<f8").astype(dtype)
        else:
            raise ValueError(f"unsupported float bit depth {bits}")
    elif fmt_tag == _WAVE_FORMAT_PCM:
        if bits == 8:  # unsigned
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float64) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(_trim(raw, 2), dtype="<i2").astype(np.float64) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8)
            n = len(b) // 3
            b = b[: n * 3].reshape(n, 3)
            vals = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float64) / 8388608.0
        elif bits == 32:
            x = np.frombuffer(_trim(raw, 4), dtype="<i4").astype(np.float64) / 2147483648.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
        x = x.astype(dtype)

    frames = len(x) // channels
    return x[: frames * channels].reshape(frames, channels), sample_rate


def read_wav_mono(path: str | Path, dtype=np.float32) -> tuple[np.ndarray, int]:
    """Read a WAV and downmix to mono the way the reference does.

    Stereo is averaged as ``l/2 + r/2`` (reference: Jefferson/src/cudaPart.cu:50-52);
    more than two channels is rejected like the reference's readFile.
    """
    x, sr = read_wav(path, dtype=dtype)
    if x.shape[1] == 1:
        return x[:, 0], sr
    if x.shape[1] == 2:
        return (x[:, 0] / 2.0 + x[:, 1] / 2.0).astype(dtype), sr
    raise ValueError(f"{path}: only mono or stereo accepted, got {x.shape[1]} channels")


def _encode(samples: np.ndarray, bits: int, float_format: bool) -> bytes:
    x = np.asarray(samples)
    # the host library quantizes float32 PCM only: float64 data through it
    # would flip +-1-LSB ties against the float64 quantizer below
    if not float_format and bits in (16, 24, 32) and x.dtype == np.float32:
        return native.encode_pcm(x, bits)
    return _encode_numpy(x, bits, float_format)


def _encode_numpy(samples: np.ndarray, bits: int, float_format: bool) -> bytes:
    """The plain form of ``_encode``, in NumPy."""
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[:, None]
    if float_format:
        if bits == 32:
            return x.astype("<f4").tobytes()
        if bits == 64:
            return x.astype("<f8").tobytes()
        raise ValueError(f"unsupported float bit depth {bits}")
    scale = float(1 << (bits - 1))
    q = np.clip(np.rint(x.astype(np.float64) * scale), -scale, scale - 1).astype(np.int64)
    if bits == 16:
        return q.astype("<i2").tobytes()
    if bits == 24:
        q32 = q.astype(np.int32).reshape(-1)
        out = np.empty((q32.size, 3), dtype=np.uint8)
        out[:, 0] = q32 & 0xFF
        out[:, 1] = (q32 >> 8) & 0xFF
        out[:, 2] = (q32 >> 16) & 0xFF
        return out.tobytes()
    if bits == 32:
        return q.astype("<i4").tobytes()
    raise ValueError(f"unsupported PCM bit depth {bits}")


def _header(sample_rate: int, channels: int, bits: int, float_format: bool, data_size: int) -> bytes:
    fmt_tag = _WAVE_FORMAT_IEEE_FLOAT if float_format else _WAVE_FORMAT_PCM
    block_align = channels * bits // 8
    byte_rate = sample_rate * block_align
    fmt_body = struct.pack(
        "<HHIIHH", fmt_tag, channels, sample_rate, byte_rate, block_align, bits
    )
    if float_format:
        fmt_body += struct.pack("<H", 0)  # cbSize, required for non-PCM
    # riff_size counts the odd-data pad byte (write_wav/close append it)
    riff_size = 4 + (8 + len(fmt_body)) + (8 + data_size) + (data_size & 1)
    if riff_size > 0xFFFFFFFF:
        raise ValueError(
            f"WAV data ({data_size} bytes) exceeds the 4 GiB RIFF limit; "
            f"split the output or use a different container"
        )
    hdr = b"RIFF" + struct.pack("<I", riff_size) + b"WAVE"
    hdr += b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
    hdr += b"data" + struct.pack("<I", data_size)
    return hdr


def resolve_float_bits(bits: int, float_format: bool) -> int:
    """Resolve a user-facing (bits, float) pair to a writable depth.

    ``--float`` means IEEE float output; the PCM-only depths (16/24 — and
    24 is the CLI/daemon *default*) resolve to float32 so "render with
    --float" never dies at write time after the render completed.  32/64
    pass through (float32/float64)."""
    if float_format and bits not in (32, 64):
        return 32
    return bits


def write_wav(
    path: str | Path,
    samples: np.ndarray,
    sample_rate: int,
    bits: int = 24,
    float_format: bool = False,
) -> None:
    """Write samples[frames] or samples[frames, channels] to a WAV file.

    Defaults to 24-bit PCM, the reference's output format
    (reference: Jefferson/src/main.cu:77-80).
    """
    x = np.asarray(samples)
    channels = 1 if x.ndim == 1 else x.shape[1]
    payload = _encode(x, bits, float_format)
    with open(path, "wb") as f:
        f.write(_header(sample_rate, channels, bits, float_format, len(payload)))
        f.write(payload)
        if len(payload) & 1:  # RIFF word alignment for odd data sizes
            f.write(b"\x00")


class StreamingWavWriter:
    """Append blocks to a WAV file incrementally.

    The analogue of the reference's per-callback ``sf_writef_float``
    append (reference: Jefferson/src/Audio.cu:161): partial renders survive
    because the header is patched on every flush/close.
    """

    def __init__(
        self,
        path: str | Path,
        sample_rate: int,
        channels: int = 2,
        bits: int = 24,
        float_format: bool = False,
    ):
        self.path = Path(path)
        self.sample_rate = sample_rate
        self.channels = channels
        self.bits = bits
        self.float_format = float_format
        self._data_size = 0
        self._f = open(self.path, "wb")
        self._f.write(_header(sample_rate, channels, bits, float_format, 0))

    # headroom below 2^32 for the header itself and the pad byte
    _MAX_DATA = 0xFFFFFFFF - 128

    def write(self, samples: np.ndarray) -> None:
        x = np.asarray(samples)
        if x.ndim == 1:
            x = x[:, None]
        if x.shape[1] != self.channels:
            raise ValueError(f"expected {self.channels} channels, got {x.shape[1]}")
        payload = _encode(x, self.bits, self.float_format)
        if self._data_size + len(payload) > self._MAX_DATA:
            # fail BEFORE writing, with a clear error: the header patched at
            # the last flush stays valid (a ~4.5 h stereo-24 live capture
            # hits this; struct.error inside flush() used to be the symptom)
            raise ValueError(
                f"WAV output would exceed the 4 GiB RIFF limit at "
                f"{self._data_size + len(payload)} data bytes; rotate the file"
            )
        self._f.write(payload)
        self._data_size += len(payload)

    def flush(self) -> None:
        pos = self._f.tell()
        self._f.seek(0)
        self._f.write(
            _header(self.sample_rate, self.channels, self.bits, self.float_format, self._data_size)
        )
        self._f.seek(pos)
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            if self._data_size & 1:  # RIFF word alignment (riff_size counts it)
                self._f.seek(0, 2)
                self._f.write(b"\x00")
            self.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
