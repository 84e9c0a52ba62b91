"""Where does the fused apply stage's rounding depart from the unfused
chain, on the card?

The counterpart of ``scripts/apply_assoc_probe.py``, with its inputs, seed
and stages; "xla" there is eager torch and cuBLAS here, "pallas" the hand
kernels of ``kernels/assoc_probe`` (rows 9-11):

  A. product: the elementwise complex product, eager torch (each product
     rounded on its own) against the hand kernel (the compiler free to
     contract ``a*b - c*d`` into an FMA), both against float64;
  B. matmul: the (256, 513) @ (513, 128) fp32 tail-IDFT contraction, cuBLAS
     (TF32 off) against the hand kernel's one chain per plane, both fed the
     same rounded product (torch's);
  C. the whole chain each way, against the float64 chain;
  D. the K = 512 contraction: cuBLAS, the hand kernel's one chain, and its
     K-chunk pairwise tree at 2, 4 and 8 chunks;
  E. (the port's own) stage C's chain through the production tail of rows
     1-8: the apply-only step (row 7), whose tail sums each 128-bin block's
     real and imaginary terms in one interleaved chain, against float64.

    python -m jefferson_tpu_torch.scripts.apply_assoc_probe [--device cuda]

Prints one line per measurement; ``main`` returns the numbers as a dict,
with ``twins``: each kernel call of stages A, B and D against its plain
twin on the same operands (row 9's worst |kernel - twin| as a share of its
plane's |product| + |product|; rows 10-11's max|kernel - twin| and the
output peak).  With ``--device cpu`` both sides are the plain twins (MKL's
matmul).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..engine.renderer import resolve_device
from ..kernels import assoc_probe
from ..kernels.fused_apply import fused_apply_xfade
from ..ops import fft as fft_ops

B, BINS, FPB, N = 256, 513, 128, 1024


def bitdiff(a: np.ndarray, b: np.ndarray) -> tuple[int, float]:
    """(#elements whose f32 bit patterns differ, max abs float diff)."""
    n = int((a.view(np.int32) != b.view(np.int32)).sum())
    return n, float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())


def inputs(seed: int = 0):
    """The probe's operands as the JAX script makes them: forward planes of
    O(1..30) (signal DFT x distance), filter planes O(1) with a KEMAR-like
    decay, and the 1024-point tail-IDFT basis -> six float32 arrays."""
    rng = np.random.default_rng(seed)
    xr = (rng.standard_normal((B, BINS)) * 8).astype(np.float32)
    xi = (rng.standard_normal((B, BINS)) * 8).astype(np.float32)
    dec = np.exp(-np.arange(BINS) / 200.0).astype(np.float32)
    gr = (rng.standard_normal((B, BINS)) * dec).astype(np.float32)
    gi = (rng.standard_normal((B, BINS)) * dec).astype(np.float32)
    icr, ici = fft_ops._idft_tail_matrices(N, FPB)
    return xr, xi, gr, gi, icr, ici


def contracted(a, b, c, d, sign: float) -> tuple[np.ndarray, np.ndarray]:
    """The two ways one FMA can hold a*b + sign*c*d, each rounded once to
    float32: (fma(a, b, sign*rn(c*d)), fma(sign*c, d, rn(a*b)))."""
    f64 = lambda x: x.astype(np.float64)
    cd, ab = (c * d).astype(np.float32), (a * b).astype(np.float32)
    return ((f64(a) * f64(b) + sign * f64(cd)).astype(np.float32),
            (sign * f64(c) * f64(d) + f64(ab)).astype(np.float32))


def run(device) -> dict:
    """Stages A-D on ``device``; prints each line and returns the numbers."""
    xr, xi, gr, gi, icr, ici = inputs()
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    fetch = lambda t: t.cpu().numpy()
    xr_d, xi_d, gr_d, gi_d, icr_d, ici_d = map(put, (xr, xi, gr, gi, icr, ici))
    f64 = lambda a: a.astype(np.float64)
    res = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    print(f"device: {res['device']}", file=sys.stderr)

    # stage A
    qx = [fetch(a) for a in assoc_probe.prod_reference(xr_d, xi_d, gr_d, gi_d)]
    qp = [fetch(a) for a in assoc_probe.prod(xr_d, xi_d, gr_d, gi_d)]
    q64r = f64(xr) * gr - f64(xi) * gi
    q64i = f64(xr) * gi + f64(xi) * gr
    stage = {}
    for name, ql in (("torch", qx), ("kernel", qp)):
        e = max(np.abs(ql[0] - q64r).max(), np.abs(ql[1] - q64i).max())
        stage[f"err_{name}"] = float(e)
        print(f"A  product {name:6s}: max err vs f64 = {e:.3e}")
    nbits, md = bitdiff(qx[0], qp[0])
    nbits_i, md_i = bitdiff(qx[1], qp[1])
    stage.update(bits_differ=[nbits, nbits_i], elements=2 * B * BINS, max_diff=max(md, md_i))
    # each plane's scale: the magnitudes of its two products
    scales = (np.abs(f64(xr) * gr) + np.abs(f64(xi) * gi),
              np.abs(f64(xr) * gi) + np.abs(f64(xi) * gr))
    twins = {"prod": {"max_abs": max(md, md_i), "of_scale": max(
        float((np.abs(f64(p) - q) / sc).max()) for p, q, sc in zip(qp, qx, scales))}}
    print(f"A  product torch-vs-kernel: {nbits}+{nbits_i} of {2 * B * BINS} elements "
          f"differ bitwise (max |diff| {max(md, md_i):.3e})")
    # which contraction, if any, the kernel's bits are, plane by plane (to
    # within the double rounding of the float64 stand-in for an FMA)
    stage["kernel_equals"] = {}
    planes = (("qr", "xr*gr", "xi*gi", (xr, gr, xi, gi, -1.0)),
              ("qi", "xr*gi", "xi*gr", (xr, gi, xi, gr, 1.0)))
    for plane, (name, ab, cd, operands) in enumerate(planes):
        forms = dict(zip((f"fma keeps {ab}", f"fma keeps {cd}", "both rounded"),
                         (*contracted(*operands), qx[plane])))
        counts = {form: int((qp[plane].view(np.int32) == want.view(np.int32)).sum())
                  for form, want in forms.items()}
        stage["kernel_equals"][name] = counts
        print(f"A  product kernel {name} bit-equal to: "
              + ", ".join(f"{form} on {n}" for form, n in counts.items())
              + f" of {B * BINS} elements")
    res["A"] = stage

    # stage B: feed both the same rounded product (torch's)
    qr_d, qi_d = put(qx[0]), put(qx[1])
    yx = fetch(assoc_probe.mm_reference(qr_d, qi_d, icr_d, ici_d))
    yp = fetch(assoc_probe.mm(qr_d, qi_d, icr_d, ici_d))
    y64 = f64(qx[0]) @ f64(icr) + f64(qx[1]) @ f64(ici)
    res["B"] = _compare("B  matmul ", yx, yp, y64, B * FPB)
    twins["mm"] = [_twin(yp, yx, k=BINS)]

    # stage C: the whole chain each way, against the float64 chain
    yfx = fetch(assoc_probe.mm_reference(*assoc_probe.prod_reference(xr_d, xi_d, gr_d, gi_d),
                                         icr_d, ici_d))
    yfp = fetch(assoc_probe.mm(*assoc_probe.prod(xr_d, xi_d, gr_d, gi_d), icr_d, ici_d))
    yf64 = q64r @ f64(icr) + q64i @ f64(ici)
    res["C"] = _compare("C  chain  ", yfx, yfp, yf64, B * FPB)

    # stage D: the K = 512 contraction, one chain and the pairwise trees
    k5 = BINS - 1
    qr5, qi5 = qx[0][:, :k5].copy(), qx[1][:, :k5].copy()
    icr5, ici5 = icr[:k5].copy(), ici[:k5].copy()
    y64_5 = f64(qr5) @ f64(icr5) + f64(qi5) @ f64(ici5)
    ops = tuple(map(put, (qr5, qi5, icr5, ici5)))
    yx5 = fetch(assoc_probe.mm_reference(*ops))
    yp5 = fetch(assoc_probe.mm(*ops))
    stage = {"err_torch": float(np.abs(yx5 - y64_5).max()),
             "err_kernel": float(np.abs(yp5 - y64_5).max()), "tree": {}}
    twins["mm"].append(_twin(yp5, yx5, k=k5))
    twins["mm_tree"] = []
    print(f"D  K=512 torch        : max err vs f64 = {stage['err_torch']:.3e}")
    print(f"D  K=512 kernel plain : max err vs f64 = {stage['err_kernel']:.3e}")
    for chunks in (2, 4, 8):
        yt = fetch(assoc_probe.mm_tree(*ops, chunks))
        twins["mm_tree"].append(
            _twin(yt, fetch(assoc_probe.mm_tree_reference(*ops, chunks)), k=k5, chunks=chunks))
        nb_, md_ = bitdiff(yx5, yt)
        err = float(np.abs(yt - y64_5).max())
        stage["tree"][chunks] = {"err": err, "bits_differ": nb_, "max_diff": md_}
        print(f"D  K=512 kernel tree{chunks}: max err vs f64 = {err:.3e} (vs torch: {nb_} "
              f"bits differ, max {md_:.3e})")
    res["D"] = stage
    res["twins"] = twins

    # stage E, the port's own: stage C's chain through the production tail
    # of rows 1-8 (row 7, no crossfade: each product rounded on its own,
    # then per output one fp32 chain per 128-bin block with the real and
    # imaginary terms interleaved, the blocks added in order)
    g = torch.cat([gr_d, gi_d, gr_d, gi_d], dim=1)
    y7 = fused_apply_xfade(xr_d, xi_d, g, None, None, icr_d, ici_d, seg=B, bins=BINS, fpb=FPB,
                           with_xfade=False)
    ye = fetch(y7[:, :FPB])
    res["E"] = {"err_kernel": float(np.abs(ye - yf64).max()),
                "bits_differ_from_chain": bitdiff(ye, yfp)[0]}
    print(f"E  chain   row 7 (blocked tail): max err vs f64 = {res['E']['err_kernel']:.3e}")
    return res


def _twin(y_kernel, y_twin, **shape) -> dict:
    """One kernel call against its twin: max|kernel - twin|, the twin's
    peak, whether the kernel's output is finite."""
    return {**shape, "max_abs": float(np.abs(y_kernel - y_twin).max()),
            "peak": float(np.abs(y_twin).max()), "finite": bool(np.isfinite(y_kernel).all())}


def _compare(label: str, y_torch, y_kernel, y64, elements: int) -> dict:
    """Print and return each side's max error against float64 and how many
    elements differ bitwise between them."""
    e_t, e_k = float(np.abs(y_torch - y64).max()), float(np.abs(y_kernel - y64).max())
    nbits, md = bitdiff(y_torch, y_kernel)
    print(f"{label} torch : max err vs f64 = {e_t:.3e}")
    print(f"{label} kernel: max err vs f64 = {e_k:.3e}")
    print(f"{label} torch-vs-kernel: {nbits} of {elements} elements differ bitwise "
          f"(max |diff| {md:.3e})")
    return {"err_torch": e_t, "err_kernel": e_k, "bits_differ": nbits, "max_diff": md}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)
    return run(resolve_device(args.device))


if __name__ == "__main__":
    main()
