#!/usr/bin/env python3
"""K3's float32 accuracy and time: the condensed factor and solve against
float64.

Run from the root of a checkout on a machine with a card:

    python3 scripts/k3_f32_accuracy.py
    mkdir -p .chipcheck/pr11 && git archive aa97ef0 piccolax_torch/csrc | tar -x -C .chipcheck/pr11
    python3 scripts/k3_f32_accuracy.py --baseline .chipcheck/pr11/piccolax_torch/csrc

Builds the kernels (as chip_smoke.py does) and holds K3's float32
factor-and-solve against the plain version in float64 on chip_smoke's KKT
inputs (`_qd_inputs`):

- "wrapper": `kkt.condense_cr_factor`, whose levels run in float64 and
  whose factor is rounded to float32 once;
- "f32 build" (with --baseline DIR): `px_cr_factor` of DIR's
  condensed_cr.cu, built here, with is_f64 0. In aa97ef0's sources that
  build runs every level in float32.

Both run K1's float32 knot factors and K3's float32 solve; the plain
float32 version (`condense_cr_factor_plain`, `condensed_solve_plain`) is
the yardstick of chip_smoke's 2x rule. Prints, for the draw on which
chip_smoke's `check_cr_solve_clusters` meets config 4's blocks
([1024,50,14,14], m = 12, its rng 28 replayed), the per-problem
quantiles of each one's end-to-end error and of its factor's error
against the float64 factor, and of its per-problem error over the plain
version's; for 20 fresh draws at the blocks of configs 4, 1, 2 and 3 the
ratio of each one's batch-max end-to-end error to the plain version's
(the quantity the 2x rule holds); and at each of those shapes the
factor's time (CUDA events, the mean of 20 calls, the builds in turns).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from piccolax_torch import _kernels  # noqa: E402
from piccolax_torch.solver import kkt  # noqa: E402

SHAPES = ((1024, 50, 14, 12), (256, 50, 14, 12), (64, 100, 24, 22), (16, 200, 44, 40))
DRAWS = 20
REPS = 20


def build_baseline(src: Path, out: Path):
    """DIR's condensed_cr.cu, built with the port's flags; its ctypes
    library."""
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libcondensed_cr_baseline.so"
    cmd = [_kernels._nvcc(), *_kernels._FLAGS, "-I", str(src), "-o", str(so),
           str(src / "condensed_cr.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed for {src}/condensed_cr.cu:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn, (argtypes, restype) in _kernels._SIGNATURES["condensed_cr"].items():
        if fn.startswith("px_cr_factor"):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
    return lib


def factor_with(lib):
    """The factor of `lib`'s px_cr_factor on float32 inputs (is_f64 0), its
    workspace sized in float64 elements (enough for a build whose
    workspace is in float32)."""
    def factor(Xi, C, R, Cn):
        B, N, m, dz = C.shape
        Np = kkt._pow2_pad(N)
        cr = torch.empty(B, 3, Np, m, m, dtype=Xi.dtype, device=Xi.device)
        ws = torch.empty(B * lib.px_cr_factor_ws(N, Np, m, dz), dtype=torch.float64,
                         device=Xi.device)
        _kernels.check(lib.px_cr_factor(0, Xi.data_ptr(), C.data_ptr(), R.data_ptr(),
                                        Cn.data_ptr(), cr.data_ptr(), ws.data_ptr(), B, N,
                                        Np, m, dz, _kernels.stream_handle(Xi)),
                       "px_cr_factor float32")
        return cr
    return factor


def errors(factors, Pm, C, R, Cn, rhs):
    """Per problem, for the plain float32 version and each factor of
    `factors` (with K3's solve): (max |x - x64| / max |x64| of the
    end-to-end solve, max |f - f64| / max |f64| of the factor)."""
    dz = Pm.shape[-1]
    Xi = kkt.chol_inv_factor(Pm)
    d = [x.double() for x in (Xi, C, R, Cn, rhs)]
    f64 = kkt.condense_cr_factor_plain(*d[:4])
    x64 = kkt.condensed_solve_plain((d[0], f64), d[1], d[3], d[4], dz)

    def err(x, ref):
        return ((x.double() - ref).abs().flatten(1).amax(1)
                / ref.abs().max()).cpu().numpy()

    f = kkt.condense_cr_factor_plain(Xi, C, R, Cn)
    out = {"plain f32": (err(kkt.condensed_solve_plain((Xi, f), C, Cn, rhs, dz), x64),
                         err(f, f64))}
    for name, factor in factors.items():
        f = factor(Xi, C, R, Cn)
        out[name] = (err(kkt.condensed_solve((Xi, f), C, Cn, rhs, dz), x64), err(f, f64))
    return out


def quantiles(v):
    return " / ".join(f"{x:.2e}" for x in np.quantile(v, [0.5, 0.9, 0.99, 1.0]))


def time_ms(fn):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="a piccolax_torch/csrc directory whose float32 factor build "
                         "to hold beside the wrapper")
    args = ap.parse_args()
    t0 = time.perf_counter()
    _kernels.build()
    factors = {"wrapper": kkt.condense_cr_factor}
    if args.baseline is not None:
        factors["f32 build"] = factor_with(
            build_baseline(args.baseline.resolve(), _kernels._BUILD / "k3_baseline"))
    print(f"{cs._card()}; build {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(28)                # check_cr_solve_clusters' stream
    for dtype, dz, m in (("float64", 15, 13), ("float32", 44, 40)):
        for B in cs.CR_SOLVE_BATCHES:
            for N in (13, 2):
                cs._qd_inputs(B, N, dz, m, dtype, rng)
    B, N, dz, m = cs.CR_SOLVE_PATHS[0]
    e = errors(factors, *cs._qd_inputs(B, N, dz, m, "float32", rng))
    print(f"check_cr_solve_clusters' draw [{B},{N},{dz},{dz}] m={m} float32, per-problem "
          f"quantiles 50 / 90 / 99 / 100%:", flush=True)
    plain = e["plain f32"][0]
    for name, (v, fv) in e.items():
        r = v / np.maximum(plain, 1e-30)
        print(f"  {name}: end-to-end {quantiles(v)}; factor {quantiles(fv)}; over the "
              f"plain version's {quantiles(r)}, worse on {np.mean(r > 1):.3f}; batch max "
              f"/ plain's {v.max() / plain.max():.2f}", flush=True)
    for B, N, dz, m in SHAPES:
        ratios = {name: [] for name in factors}
        for seed in range(DRAWS):
            e = errors(factors, *cs._qd_inputs(B, N, dz, m, "float32",
                                               np.random.default_rng(1000 + seed)))
            for name in ratios:
                ratios[name].append(e[name][0].max() / e["plain f32"][0].max())
        for name, r in ratios.items():
            r = np.array(r)
            print(f"[{B},{N},{dz},{dz}] m={m} {name}: batch-max error / plain's over "
                  f"{DRAWS} draws: " + " ".join(f"{x:.2f}" for x in r)
                  + f"; above 2: {int((r > 2).sum())}", flush=True)
        Pm, C, R, Cn, _ = cs._qd_inputs(B, N, dz, m, "float32", np.random.default_rng(7))
        Xi = kkt.chol_inv_factor(Pm)
        turns = {name: [] for name in factors}
        for _ in range(2):
            for name, factor in factors.items():
                turns[name].append(time_ms(lambda f=factor: f(Xi, C, R, Cn)))
        print(f"[{B},{N},{dz},{dz}] m={m} factor ms (turns): " + "; ".join(
            f"{name} {' / '.join(f'{t:.4f}' for t in ts)}" for name, ts in turns.items()),
            flush=True)


if __name__ == "__main__":
    main()
