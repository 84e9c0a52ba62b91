"""SOFA HRTF sets on the card: load a modern (AES69) file, dense or
sparse, and render.  (The port's copy of ``examples/10_sofa.py``.)

The reference only reads the 1994 MIT KEMAR WAV trees
(reference: Jefferson/src/hrtf_signals.cu:124-133); virtually every HRTF
set published since (HUTUBS, SADIE II, ARI, personalized measurements)
ships as SOFA `SimpleFreeFieldHRIR` instead.  `jt.load_database` detects
`.sofa` files and maps the measurements onto the engine's 710-point KEMAR
grid, so everything downstream (interpolation, crossfade, kernels) is
unchanged.

This example builds a SPARSE "personalized measurement" set (48
directions), writes it as a SOFA file, and shows why the mapping choice
matters: nearest-snap aliases neighbouring grid directions onto the same
measurement, while the delay-aligned 3-nearest interpolation
(`mapping="interp3"`, what `"auto"` picks for sparse sets) tracks the
underlying smooth field.  It then renders an orbit through the loaded set.

    python jefferson_tpu_torch/examples/10_sofa.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo-root import

import numpy as np

import jefferson_tpu_torch as jt
from jefferson_tpu_torch.engine.renderer import Renderer
from jefferson_tpu_torch.hrtf.kemar import NUM_HRTF, grid_position
from jefferson_tpu_torch.hrtf.sofa import load_sofa
from jefferson_tpu_torch.trajectory.trajectory import CircularOrbit

cfg = jt.DEFAULT_CONFIG


def listener_ir(azi_deg: float, ele_deg: float) -> np.ndarray:
    """Ground-truth 'listener': a Hann pulse whose per-ear amplitude and
    onset vary smoothly with direction (ILD ~ sin(azi)cos(ele), ITD ~
    cos(azi)cos(ele)): the shape any real measurement discretizes."""
    a, e = np.deg2rad(azi_deg), np.deg2rad(ele_deg)
    lat = np.sin(a) * np.cos(e)
    d = 12 + int(round(5.0 * (1.0 - np.cos(a) * np.cos(e))))
    ir = np.zeros((2, cfg.hrtf_len))
    ir[0, d : d + 9] = (1.0 - 0.45 * lat) * np.hanning(9)
    ir[1, d : d + 9] = (1.0 + 0.45 * lat) * np.hanning(9)
    return ir


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    try:
        import h5py
    except ImportError:  # SOFA is optional: the engine core never needs HDF5
        print("h5py not installed; the SOFA loader is unavailable on this host")
        return 0

    # --- 1. "measure" the listener at 48 sparse directions and write SOFA ----
    mazi, mele = [], []
    for e in (-30.0, 0.0, 30.0, 60.0):
        for a in np.arange(0.0, 360.0, 30.0):
            mazi.append(a)
            mele.append(e)
    ir = np.stack([listener_ir(a, e) for a, e in zip(mazi, mele)])

    # SOFA spherical azimuth is counterclockwise-from-ahead; the engine's is
    # clockwise (reference: Jefferson/src/SoundSource.cu:28-33): negate.
    pos = np.stack([np.mod(-np.asarray(mazi), 360.0), mele, np.full(len(ir), 1.4)], axis=1)
    with h5py.File("listener.sofa", "w") as f:
        f.create_dataset("Data.IR", data=ir)
        f.create_dataset("Data.SamplingRate", data=np.array([float(cfg.sample_rate)]))
        d = f.create_dataset("SourcePosition", data=pos)
        d.attrs["Type"] = np.bytes_("spherical")

    # --- 2. load it: nearest-snap vs the interpolating mapping ---------------
    near = load_sofa("listener.sofa", cfg, mapping="nearest")
    db = jt.load_database("listener.sofa", cfg)  # auto -> interp3 (sparse set)
    if not db.source.endswith(":interp3"):
        raise SystemExit(f"auto mapping picked {db.source}, not interp3")

    idxs = [i for i in range(NUM_HRTF) if -30.0 <= grid_position(i)[0] <= 60.0]
    truth = np.stack([listener_ir(grid_position(i)[1], grid_position(i)[0]) for i in idxs])
    rms = lambda d: float(np.sqrt(np.mean(d**2)))
    err_n = rms(near.hrirs[idxs, :, : cfg.hrtf_len] - truth)
    err_i = rms(db.hrirs[idxs, :, : cfg.hrtf_len] - truth)
    collapsed = sum(np.array_equal(near.hrirs[i], near.hrirs[j]) for i, j in zip(idxs, idxs[1:]))
    print(f"48 measurements -> {len(idxs)} grid directions: nearest-snap collapses "
          f"{collapsed} adjacent pairs, RMS err {err_n:.4f}; interp3 {err_i:.4f} "
          f"({err_i / err_n:.2f}x)")
    if not err_i < err_n:
        raise SystemExit("interp3 does not track the field better than nearest-snap")

    # --- 3. render through the personalized set ------------------------------
    sr = cfg.sample_rate
    t = np.arange(2 * sr) / sr
    sig = (0.4 * np.sin(2 * np.pi * 330 * t) * np.exp(-(t % 0.4) * 8)).astype(np.float32)
    positions = CircularOrbit(period_s=2.0, ele=0, r=1.0).sample(
        len(sig) // cfg.frames_per_buffer, cfg)
    out = Renderer(db, cfg, device=args.device).render(sig, positions)
    jt.write_wav("sofa_orbit.wav", out, sr)

    # the rendered image must move with the orbit (left-dominant when the
    # source is left, right-dominant when right): the direction dependence
    # the sparse set keeps only if the mapping did not alias it away
    half = out.shape[0] // 2
    q = out[: half // 2], out[half + half // 2 :]
    lr0 = rms(q[0][:, 0]) / rms(q[0][:, 1])
    lr1 = rms(q[1][:, 0]) / rms(q[1][:, 1])
    print(f"rendered {out.shape[0] / sr:.1f}s orbit on {args.device} -> sofa_orbit.wav  "
          f"(first quarter L/R RMS {lr0:.2f}, last quarter {lr1:.2f})")
    if not (lr0 - 1.0) * (lr1 - 1.0) < 0:
        raise SystemExit("stereo image did not cross sides")
    return 0


if __name__ == "__main__":
    sys.exit(main())
