#!/usr/bin/env python3
"""Smoke test of piccolax_torch on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
fatal on failure:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles every kernel of piccolax_torch/csrc with nvcc;
3. kernels: runs each kernel and its plain PyTorch version on the card
   at the shapes of the config-1 solve (inputs from a numpy seed), checks
   the stated tolerance (and K1's per-matrix NaN mask), and times the
   kernel, the plain version and a yardstick PyTorch library call;
4. main path: BASELINE config 1 (SX gate, N = 50, T = 10) at B = 256 in
   float32 with the bench options, solved on the card with every launch
   counter reset just before; checks that every kernel ran, then gates
   the solved pulses with a float64 DOP853 re-integration.

Prints the {"kernels": [...]} record, then as the last line
{"ok": true, "device": {...}}. Exits nonzero, with no result line,
without a card or when any phase fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

H100_F32_FLOPS = 67e12      # FP32 outside the tensor cores, SXM, 700 W
H100_BYTES_PER_S = 3.35e12  # HBM3


def _check(ok, message):
    """A failed check ends the run (kept under python -O, unlike assert)."""
    if not ok:
        raise RuntimeError(message)


def _bound(flops, nbytes):
    t_ops = flops / H100_F32_FLOPS
    t_bytes = nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def _time_ms(fn, reps=20):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _rel_err(a, b):
    import torch
    fin = torch.isfinite(b)
    d = (a[fin].double() - b[fin].double()).abs().max().item()
    return d, d / max(b[fin].double().abs().max().item(), 1e-30)


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[0]


def check_kernels(B, N, record):
    """Phase 3: every kernel against its plain version at main-path shapes."""
    import torch
    from piccolax_torch import _kernels
    from piccolax_torch.ops import expm as ex
    from piccolax_torch.solver import kkt

    dev = torch.device("cuda")
    f32 = torch.float32
    rng = np.random.default_rng(1234)
    dz, m, nd = 14, 12, 2
    Np = 64

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=f32, device=dev)

    # -- K2: psd_clamp on symmetric indefinite knot Hessians [B, N, 14, 14]
    W = rng.standard_normal((B, N, dz, dz))
    W = t(0.5 * (W + np.swapaxes(W, -1, -2)))
    iters, floor_rel = 15, 3e-3
    errs = {}
    for mode in ("pos", "abs"):
        got = kkt.psd_clamp(W, floor_rel, iters, mode)
        ref = kkt.psd_clamp_plain(W, floor_rel, iters, mode)
        errs[mode], rel = _rel_err(got, ref)
        _check(rel < 1e-4, f"psd_clamp({mode}) rel err {rel}")
    M = B * N
    flops = M * (iters * 4 * dz ** 3 + 2 * dz ** 3 + 6 * dz * dz)
    # the row describes mode "pos", the one the main path runs
    record("psd_clamp", "piccolax_torch/csrc/psd_clamp.cu",
           "piccolax/solver/kkt.py:150", errs["pos"],
           _time_ms(lambda: kkt.psd_clamp(W, floor_rel, iters, "pos")),
           _time_ms(lambda: kkt.psd_clamp_plain(W, floor_rel, iters, "pos")),
           _bound(flops, 2 * M * dz * dz * 4),
           _time_ms(lambda: _eigh_clamp(W, floor_rel)),
           f"1e-4 relative, mode pos; mode abs max_err={errs['abs']:.3e}")

    # -- K1: chol_inv_factor on SPD knot blocks, 1 in 8 made indefinite
    P = kkt.psd_clamp_plain(W, floor_rel, iters) + \
        torch.diag_embed(t(rng.uniform(0.0, 5.0, (B, N, dz))))
    bad = rng.random((B, N)) < 0.125
    A = torch.where(t(bad)[..., None, None] > 0,
                    P - 10.0 * torch.eye(dz, device=dev), P).contiguous()
    got = kkt.chol_inv_factor(A)
    ref = kkt.chol_inv_factor_plain(A)
    nan_k = torch.isnan(got).any(-1).any(-1)
    nan_p = torch.isnan(ref).any(-1).any(-1)
    _check(torch.equal(nan_k, nan_p), "chol_inv_factor NaN mask differs")
    _check(nan_k.sum().item() > 0, "indefinite blocks were not flagged")
    err, rel = _rel_err(got, ref)
    _check(rel < 1e-4, f"chol_inv_factor rel err {rel}")
    flops = M * (dz ** 3 + 3 * dz * dz)
    record("chol_inv_factor", "piccolax_torch/csrc/chol_inv.cu",
           "piccolax/solver/kkt.py:127", err,
           _time_ms(lambda: kkt.chol_inv_factor(P)),
           _time_ms(lambda: kkt.chol_inv_factor_plain(P)),
           _bound(flops, 2 * M * dz * dz * 4),
           _time_ms(lambda: _library_chol_inv(P)), "1e-4 relative, same NaN mask")

    # -- K3: condensed factor and solve, [B, N] knots of dz = 14, m = 12
    C = t(0.3 * rng.standard_normal((B, N, m, dz)))
    Cn = t(0.3 * rng.standard_normal((B, N - 1, m, dz)))
    R = np.full((B, N, m), 1e-3)
    R[:, -1] += 1.0
    R = t(R)
    fk = kkt.condensed_factor(P, C, R, Cn)
    fp = kkt.condensed_factor_plain(P, C, R, Cn)
    err_f, rel = _rel_err(fk[1], fp[1])
    _check(rel < 1e-3, f"condensed_factor rel err {rel}")
    rhs = t(rng.standard_normal((B, N, dz + m, 1)))
    xk = kkt.condensed_solve(fk, C, Cn, rhs, dz)
    xp = kkt.condensed_solve_plain(fp, C, Cn, rhs, dz)
    err_s, rel = _rel_err(xk, xp)
    _check(rel < 1e-3, f"condensed_solve rel err {rel}")
    levels = sum(Np >> (k + 1) for k in range(6)) + 1
    f_flops = B * (2 * N * m * dz * dz * 2 + N * m * m * dz * 2 * 3
                   + levels * (m ** 3 + 3 * m * m) + (Np - 1) * 5 * 2 * m ** 3)
    f_bytes = 4 * B * (N * dz * dz + N * m * dz + N * m + (N - 1) * m * dz
                       + 3 * Np * m * m)
    Xi = fk[0]
    record("condensed_factor", "piccolax_torch/csrc/condensed_cr.cu",
           "piccolax/solver/kkt.py:445", err_f,
           _time_ms(lambda: kkt.condense_cr_factor(Xi, C, R, Cn)),
           _time_ms(lambda: kkt.condense_cr_factor_plain(Xi, C, R, Cn)),
           _bound(f_flops, f_bytes), None,
           "1e-3 relative; timed from the knot factors Xi (K1 excluded)")
    s_flops = B * (N * 4 * dz * dz + N * 4 * m * dz * 2
                   + (Np - 1) * 6 * 2 * m * m + 2 * m * m)
    s_bytes = 4 * B * (N * dz * dz + N * m * dz + (N - 1) * m * dz
                       + 3 * Np * m * m + 2 * N * (dz + m))
    record("condensed_solve", "piccolax_torch/csrc/condensed_cr.cu",
           "piccolax/solver/kkt.py:464", err_s,
           _time_ms(lambda: kkt.condensed_solve(fk, C, Cn, rhs, dz)),
           _time_ms(lambda: kkt.condensed_solve_plain(fp, C, Cn, rhs, dz)),
           _bound(s_flops, s_bytes), None, "1e-3 relative")

    # -- K4: expm on the line-search residual shape [B * 2 * 6, N-1, 4, 4]
    # and on the 12 x 12 derivative augmentations [B, N-1, 4, 12, 12]
    from piccolax_torch.quantum.systems import QuantumSystem
    from piccolax_torch.quantum.gates import PAULIS
    sysv = QuantumSystem(np.zeros((2, 2)), [PAULIS["X"] / 2, PAULIS["Y"] / 2],
                         1.0).solver_view().to(dev, f32)
    dt = 10.0 / (N - 1)
    u = t(rng.uniform(-1, 1, (B * 12, N - 1, nd)))
    Aexp = (dt * sysv.G(u)).contiguous()
    got = ex.expm_taylor_fixed(Aexp, 8, 0)
    ref = ex.expm_taylor_fixed_plain(Aexp, 8, 0)
    err, rel = _rel_err(got, ref)
    _check(rel < 1e-5, f"expm_taylor_fixed rel err {rel}")
    Aaug = t(0.1 * rng.standard_normal((B, N - 1, 4, 12, 12)))
    e12, rel12 = _rel_err(ex.expm_taylor_fixed(Aaug, 8, 1),
                          ex.expm_taylor_fixed_plain(Aaug, 8, 1))
    _check(rel12 < 1e-5, f"expm_taylor_fixed 12x12 rel err {rel12}")
    Mx = Aexp.numel() // 16
    record("expm_taylor_fixed", "piccolax_torch/csrc/expm_taylor.cu",
           "piccolax/ops/expm.py:143", max(err, e12),
           _time_ms(lambda: ex.expm_taylor_fixed(Aexp, 8, 0)),
           _time_ms(lambda: ex.expm_taylor_fixed_plain(Aexp, 8, 0)),
           _bound(Mx * (4 * 2 * 64 + 10 * 16), 2 * Mx * 16 * 4),
           _time_ms(lambda: torch.linalg.matrix_exp(Aexp)),
           "1e-5 relative (4 x 4 timed; 12 x 12 checked)")


def check_kernels_f64(B, N):
    """Every kernel against its plain version in float64 (untimed): the
    kernels are templated on the type, and the float64 path is the one
    the CPU tests hold against piccolax."""
    import torch
    from piccolax_torch.ops import expm as ex
    from piccolax_torch.solver import kkt

    rng = np.random.default_rng(99)
    dz, m = 14, 12

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float64,
                               device="cuda")

    W = rng.standard_normal((B, N, dz, dz))
    W = t(0.5 * (W + np.swapaxes(W, -1, -2)))
    errs = {}
    for mode in ("pos", "abs"):
        errs[f"psd_clamp {mode}"] = _rel_err(kkt.psd_clamp(W, 1e-6, 32, mode),
                                             kkt.psd_clamp_plain(W, 1e-6, 32, mode))[1]
    P = kkt.psd_clamp_plain(W, 1e-6, 32) + \
        torch.diag_embed(t(rng.uniform(0.5, 5.0, (B, N, dz))))
    errs["chol_inv_factor"] = _rel_err(kkt.chol_inv_factor(P),
                                       kkt.chol_inv_factor_plain(P))[1]
    C = t(0.3 * rng.standard_normal((B, N, m, dz)))
    Cn = t(0.3 * rng.standard_normal((B, N - 1, m, dz)))
    R = t(np.full((B, N, m), 1e-3))
    fk = kkt.condensed_factor(P, C, R, Cn)
    fp = kkt.condensed_factor_plain(P, C, R, Cn)
    errs["condensed_factor"] = _rel_err(fk[1], fp[1])[1]
    rhs = t(rng.standard_normal((B, N, dz + m, 2)))
    errs["condensed_solve"] = _rel_err(kkt.condensed_solve(fk, C, Cn, rhs, dz),
                                       kkt.condensed_solve_plain(fp, C, Cn, rhs, dz))[1]
    for n, s in ((4, 0), (12, 2)):
        A = t(0.3 * rng.standard_normal((B, N - 1, n, n)))
        errs[f"expm_taylor_fixed {n}x{n}"] = _rel_err(
            ex.expm_taylor_fixed(A, 12, s), ex.expm_taylor_fixed_plain(A, 12, s))[1]
    print("float64 kernel vs plain, relative: " +
          ", ".join(f"{k} {v:.1e}" for k, v in errs.items()), flush=True)
    for k, v in errs.items():
        _check(v < 1e-9, f"float64 {k} rel err {v}")


def _eigh_clamp(W, floor_rel):
    import torch
    ew, V = torch.linalg.eigh(W)
    return (V * torch.clamp(ew, min=0)[..., None, :]) @ V.mT + \
        floor_rel * torch.eye(W.shape[-1], device=W.device)


def _library_chol_inv(A):
    import torch
    L, _ = torch.linalg.cholesky_ex(A)
    eye = torch.eye(A.shape[-1], device=A.device).expand_as(A)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def main_path(B, N, T):
    """Phase 4: config 1 through the port's entry points, on the card."""
    import torch
    import piccolax_torch as pt
    from piccolax_torch import _kernels
    from piccolax_torch.quantum.gates import GATES
    from piccolax_torch.verification import (batched_unitary_dop853,
                                             iso_vec_to_operator_np,
                                             unitary_fidelity_np)

    prob = pt.sx_gate_problem(N=N, T=T)
    nlp, params, Z0, g0, layout = prob.build(device="cuda")
    u_sl = layout.slices["u"]
    rng = np.random.default_rng(0)
    Zb = np.broadcast_to(Z0.cpu().numpy().astype(np.float32)[None],
                         (B, N, layout.z_dim)).copy()
    Zb[:, :, u_sl] += 0.02 * rng.standard_normal(
        (B, N, u_sl.stop - u_sl.start)).astype(np.float32)
    Zb = torch.as_tensor(Zb, device="cuda")
    opts = pt.IPMOptions(max_iter=60, tol=5e-3, constr_viol_tol=5e-3,
                         ls_iters=6, clamp_iters=15)
    pt.solve_nlp(nlp, params, Zb, device="cuda",        # warm-up, 2 iterations
                 options=pt.IPMOptions(**{**opts.__dict__, "max_iter": 2}))
    _kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = pt.solve_nlp(nlp, params, Zb, options=opts, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    iters = int(st.it.max().item())
    print(f"main path: B={B} N={N} f32, {iters} iterations (max), "
          f"{seconds:.3f} s, {B / seconds:.2f} solves/s", flush=True)
    print(f"launches: {json.dumps(launches)}; per IPM iteration: "
          + json.dumps({k: round(v / iters, 2) for k, v in launches.items()}),
          flush=True)
    for k, v in launches.items():
        _check(v > 0, f"kernel {k} was not launched on the main path")

    Z = st.Z.double().cpu().numpy()
    _check(np.all(np.isfinite(Z)) and Z.shape == (B, N, layout.z_dim),
           f"solution not finite or of shape {Z.shape}")
    us = Z[:, :, u_sl]
    times = np.linspace(0, T, N)
    X = np.array([[0, 1], [1, 0]], complex)
    Y = np.array([[0, -1j], [1j, 0]], complex)
    t1 = time.perf_counter()
    U64 = batched_unitary_dop853(np.zeros((2, 2)), [X / 2, Y / 2], us, times,
                                 rtol=1e-10, atol=1e-10)
    Fs = unitary_fidelity_np(U64, GATES["SX"])
    F_rep = unitary_fidelity_np(
        iso_vec_to_operator_np(Z[:, -1, layout.slices["U"]]), GATES["SX"])
    dF = np.abs(F_rep - Fs)
    n_conv = int(st.converged.sum().item())
    print(f"quality: converged={n_conv}/{B}, f64-DOP853 mean_F={Fs.mean():.6f}, "
          f"frac_F>0.999={np.mean(Fs > 0.999):.4f}, mean|dF|={dF.mean():.2e}, "
          f"max|dF|={dF.max():.2e}, dop853 {time.perf_counter() - t1:.1f} s",
          flush=True)
    _check(n_conv >= int(np.ceil(250 / 256 * B)), f"converged {n_conv}/{B}")
    _check(np.mean(Fs > 0.999) >= 0.98, "frac_F>0.999 below 0.98")
    return launches, seconds, iters, (nlp, params, Zb, opts)


def profile(run, seconds):
    """One more main-path solve under torch.profiler: device time by
    kernel and the device busy share of the profiled wall time. The idle
    share of the unprofiled solve (`seconds`) is only estimated, from the
    profiled busy time, since the profiler is what measures busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    import piccolax_torch as pt
    nlp, params, Zb, opts = run
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pt.solve_nlp(nlp, params, Zb, options=opts, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = 0.0
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    cur_s, cur_e = None, None
    for s_, e_ in spans:
        if cur_e is None or s_ > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    if cur_e is not None:
        busy += cur_e - cur_s
    print(f"profile: wall {wall:.3f} s (profiled), device busy {busy / 1e6:.3f} s, "
          f"idle share {1 - busy / 1e6 / wall:.3f}, {len(events)} device events; "
          f"estimated idle share of the unprofiled {seconds:.3f} s solve "
          f"{1 - busy / 1e6 / seconds:.3f}", flush=True)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
    print(table, flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one more main-path solve")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import piccolax_torch  # noqa: F401  (fails outside a checkout)
    from piccolax_torch import _kernels

    card = _card()
    print(card, flush=True)
    t0 = time.perf_counter()
    _kernels.build()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

    B, N, T = 256, 50, 10.0
    rows = []

    def record(name, source, replaces, err, ms, plain_ms, bound, library_ms,
               tol):
        bound_ms, bound_by = bound
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library_ms})
        lib = "none (no single PyTorch call)" if library_ms is None \
            else f"{library_ms:.4f}"
        print(f"{name}: max_err={err:.3e} ({tol}), kernel_ms={ms:.4f}, "
              f"plain_ms={plain_ms:.4f}, library_ms={lib}, "
              f"bound_ms={bound_ms:.4f} ({bound_by})", flush=True)

    check_kernels(B, N, record)
    check_kernels_f64(8, N)
    launches, seconds, iters, run = main_path(B, N, T)
    if args.profile:
        profile(run, seconds)
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
