#!/usr/bin/env python3
"""Smoke test of piccolax_torch on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
fatal on failure:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles every kernel of piccolax_torch/csrc with nvcc, one
   process per source, all at once;
3. kernels: runs each kernel and its plain PyTorch version on the card
   (inputs from a numpy seed), checks the stated tolerance, and times the
   kernel, the plain version and a yardstick PyTorch library call: K1-K4
   at the config-1 shapes in float32 and at the quickstart shapes in
   float64, K5 (Pade-13 expm) on complex128 and complex64 rollouts with
   every squaring count 0..16, K6 (fixed-order Pade expm, orders 3-9) at
   the Pade quickstart's residual shapes and at 12 x 12, the derivative
   form of K4 and K6 (one launch: r(A) with its first and second
   derivatives along d directions, no augmentation) at every path's
   (w, d, order, s, dtype) on the paths' own systems, against its plain
   version (float64 to 1e-9 for K4, 1e-12 for K6; float32 against float64,
   2x rule) and against the dense kernel on the augmentations, then Pade
   orders 3-9 and both Taylor orders at s 0 and 2, a (w, d) sweep up to the
   width cap of 16 whose larger d split a knot's pairs over several thread
   blocks, and the value form at every width 1-32, K7 (the qd KKT
   factor and solve, with one indefinite block whose NaNs must stay in
   its problem) at config 1's, the quickstart's (B = 256 and 1) and the
   CNOT's shapes, at its caps (64 in float32, 48 in float64) and at N = 1
   and 2 (float32 against the plain version in float64, on three seeds),
   at a sweep of widths that reaches every pivot count of its Cholesky
   inverse, then that K7 and K8 refuse wider blocks, and K8 (the
   lower-triangular inverse, on no solve path) at [25600, m, m] for
   m = 16, 32, 44, 64;
4. config 1: the SX gate (N = 50, T = 10) at B = 256 in float32, gated
   with a float64 DOP853 re-integration;
5. quickstart: docs/quickstart.py steps 1-5 (N = 100, T = 10, free
   timesteps) through the port's entry points in float64, B = 1;
6. batched quickstart: the same problem at B = 256 with perturbed pulses
   in one batched float64 solve, then one batched rollout of every
   extracted pulse;
7. Pade/qd quickstart: phase 5 with SmoothPulseProblem(pade_order=7) and
   IPMOptions(kkt_backend="qd");
8. batched Pade/qd quickstart: phase 6 with the same two options;
9. config 1 on the qd backend: phase 4 with kkt_backend="qd";
10. config 3: the CNOT (N = 200, T = 50) at B = 16 in float32 on "cr",
    options as bench.py's config-3 run, gated with a float64 DOP853
    re-integration (F > 0.999 on all 16);
11. CNOT on the knot backend: B = 1, float64, kkt_backend="knot" with
    P = 4 and P = 8 partitions, 40 iterations each beside "cr" from the
    same Z0 (same it, Z to rtol 1e-7), then one P = 8 solve to its end,
    gated by DOP853 F > 0.999;
12. qd on the CNOT: phase 10 with kkt_backend="qd" (B = 16, float32, the
    same gate), then the CNOT at B = 1 in float64 on "qd": 40 iterations
    reported beside phase 11's "cr" run (the largest Z difference), and
    one solve to its end (max_iter 250, tol 1e-6), gated by DOP853
    F > 0.999.

Phase 3 also checks K1-K3 at config 3's shapes ([16, 200, 44, 44], m = 40
in float32; B = 1 in float64), K4 and K6 (Pade order 7) at the CNOT's 8 x 8
residual sweeps (both dtypes) and K9
(the knot-partitioned factor and solve at the same shapes with P = 4 and
8, and the standalone and batched block-tridiagonal solves at
[B, 48, 5, 5]). K3 and K9 are held as K7 is: float64 to 1e-9 of the plain
version, float32 against the plain version in float64 on three seeds (at
most twice the plain float32 version's error), and one indefinite dual
block whose NaN mask must equal the plain version's and stay in its
problem; K1, K3 and K9 also at a sweep of widths that reaches every
register class of their Cholesky inverse (up to the cap of 64), with an
interior of one knot (K9) and N short of a power of two. K2 in float32 is
also held against the plain version in float64 (at most twice the plain
float32 version's error, three seeds), and at a sweep of widths reaching
each padding class (n = 1 to 64, both types and modes) with a NaN block
whose mask must equal the plain version's and a block one ulp short of
symmetric, which must come out all NaN (the kernels take exactly
symmetric blocks); K3's solve at B = 1, 2, 12, 16, 24, 64 and 256 (every
cluster size it launches with) and N = 13 and 2, one launch a call. The
paths print K4's and K6's launches by block width and form (residual
sweeps, derivative launches), and fail if the value form ran on a 12- or
24-wide augmentation.

Each of 4-12 resets every launch counter just before it and reads them
just after, and fails if a kernel of its path was not launched or a
kernel of another path was (no fallback). Prints
the {"kernels": [...]} record, then as the last line {"ok": true,
"device": {...}}. Exits nonzero, with no result line, without a card or
when any phase fails. ``--profile`` also profiles config 1 and the four
quickstart solves; ``--profile-cnot`` profiles 20-iteration windows of
config 3 and of the CNOT on "cr" and on "knot" (P = 8); ``--profile-qd``
20-iteration windows of every "qd" path (the Pade/qd quickstart at B = 1
and 256, config 1, config 3 and the CNOT).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks for each type (NVIDIA data sheet, 700 W): float32
# outside the tensor cores, float64 through them (DMMA; 34e12 outside)
H100_FLOPS = {"float32": 67e12, "float64": 67e12}
H100_BYTES_PER_S = 3.35e12  # HBM3
SECTOR = 32  # bytes, the least a read from device memory moves

QS_N, QS_T, QS_B = 100, 10.0, 256
# config 3: bench.py's config-3 options (bench.py:239-244)
C3_N, C3_T, C3_B = 200, 50.0, 16
KNOT_PARTS = (4, 8)


def _check(ok, message):
    """A failed check ends the run (kept under python -O, unlike assert)."""
    if not ok:
        raise RuntimeError(message)


def _bound(flops, nbytes, real="float32"):
    t_ops = flops / H100_FLOPS[real]
    t_bytes = nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def _lower_tri_bytes(m, es):
    """Bytes of the sectors that hold the lower triangle of one row-major
    m x m matrix of es-byte entries that starts on a sector boundary."""
    total = 0
    for i in range(m):
        first = i * m * es
        last = first + (i + 1) * es - 1
        total += (last // SECTOR - first // SECTOR + 1) * SECTOR
    return total


def _sync():
    import torch
    torch.cuda.synchronize()


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


def _sym(rng, lead, t):
    """Symmetric indefinite blocks [*lead[:-1], n, n], n = lead[-1], N(0, 1)
    symmetrized, on the card through t."""
    W = rng.standard_normal((*lead, lead[-1]))
    return t(0.5 * (W + np.swapaxes(W, -1, -2)))


def _k2_vs_float64(W, floor_rel, iters, mode, label):
    """K2 in float32 against the plain version in float64 on the same
    inputs: at most twice the plain float32 version's relative error (or
    1e-6). Returns both errors."""
    from piccolax_torch.solver import kkt
    ref = kkt.psd_clamp_plain(W.double(), floor_rel, iters, mode)
    ek = _rel_err(kkt.psd_clamp(W, floor_rel, iters, mode), ref)[1]
    ep = _rel_err(kkt.psd_clamp_plain(W, floor_rel, iters, mode), ref)[1]
    _check(ek <= max(2 * ep, 1e-6), f"psd_clamp {label} float32 ({mode}): rel err vs "
           f"float64 {ek:.3e}, over twice the plain float32 version's {ep:.3e}")
    return ek, ep


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[0]


def check_kernels(B, N, dz, m, dtype, record, reps=20, clamp=None, k4=True,
                  variant=None):
    """Phase 3, K1-K4: every kernel against its plain version at the
    shapes of a path: B problems of N knots, dz columns, m rows; K4 on the
    line-search residual sweep (unless k4 is False; its derivative form:
    check_expm_derivatives). clamp: K2's (sweeps, floor), the IPM's for the
    dtype unless given; variant: the record's key for the shapes."""
    import torch
    from piccolax_torch.ops import expm as ex
    from piccolax_torch.quantum.systems import QuantumSystem
    from piccolax_torch.quantum.gates import PAULIS
    from piccolax_torch.solver import kkt

    dev = torch.device("cuda")
    dt_ = getattr(torch, dtype)
    f64 = dtype == "float64"
    es = 8 if f64 else 4
    rng = np.random.default_rng(1234 if not f64 else 99)
    Np = kkt._pow2_pad(N)
    tol = {"K1": 1e-9 if f64 else 1e-4, "K2": 1e-9 if f64 else 1e-4,
           "K4": 1e-9 if f64 else 1e-5}

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt_, device=dev)

    def bound(flops, nbytes):
        return _bound(flops, nbytes, dtype)

    # -- K2: psd_clamp on symmetric indefinite knot Hessians [B, N, dz, dz]
    # (float32 also against the plain version in float64, 2x rule)
    W = _sym(rng, (B, N, dz), t)
    iters, floor_rel = clamp or ((32, 1e-6) if f64 else (15, 3e-3))
    errs = {}
    for mode in ("pos", "abs"):
        got = kkt.psd_clamp(W, floor_rel, iters, mode)
        ref = kkt.psd_clamp_plain(W, floor_rel, iters, mode)
        errs[mode], rel = _rel_err(got, ref)
        _check(rel < tol["K2"], f"psd_clamp({mode}, {dtype}) rel err {rel}")
    if not f64:
        for seed in (None, *QD_F32_SEEDS):
            Ws = W if seed is None else _sym(np.random.default_rng(seed), (B, N, dz), t)
            _k2_vs_float64(Ws, floor_rel, iters, "pos",
                           f"[{B},{N},{dz},{dz}] seed {seed or 1234}")
    M = B * N
    # S, P = 0.5 S S, P S and the last S Y are symmetric (polynomials in W):
    # each product needs dz^2 (dz + 1) / 2 multiply-adds, two a sweep
    flops = M * (iters * 2 * dz * dz * (dz + 1) + dz * dz * (dz + 1) + 6 * dz * dz)
    # the row describes mode "pos", the one the main paths run
    record("psd_clamp", "piccolax_torch/csrc/psd_clamp.cu",
           "piccolax/solver/kkt.py:150", errs["pos"],
           _time_ms(lambda: kkt.psd_clamp(W, floor_rel, iters, "pos"), reps),
           _time_ms(lambda: kkt.psd_clamp_plain(W, floor_rel, iters, "pos"), reps),
           bound(flops, 2 * M * dz * dz * es),
           _time_ms(lambda: _eigh_clamp(W, floor_rel), reps),
           f"{tol['K2']:.0e} relative, mode pos; mode abs max_err={errs['abs']:.3e}",
           shape=f"[{B},{N},{dz},{dz}] {dtype}, {iters} sweeps", variant=variant)

    # -- K1: chol_inv_factor on SPD knot blocks, 1 in 8 made indefinite
    P = kkt.psd_clamp_plain(W, floor_rel, iters) + \
        torch.diag_embed(t(rng.uniform(0.5 if f64 else 0.0, 5.0, (B, N, dz))))
    bad = rng.random((B, N)) < 0.125
    A = torch.where(t(bad)[..., None, None] > 0,
                    P - 10.0 * torch.eye(dz, device=dev, dtype=dt_), P).contiguous()
    got = kkt.chol_inv_factor(A)
    ref = kkt.chol_inv_factor_plain(A)
    nan_k = torch.isnan(got).any(-1).any(-1)
    nan_p = torch.isnan(ref).any(-1).any(-1)
    _check(torch.equal(nan_k, nan_p), "chol_inv_factor NaN mask differs")
    _check(nan_k.sum().item() > 0, "indefinite blocks were not flagged")
    err, rel = _rel_err(got, ref)
    _check(rel < tol["K1"], f"chol_inv_factor ({dtype}) rel err {rel}")
    record("chol_inv_factor", "piccolax_torch/csrc/chol_inv.cu",
           "piccolax/solver/kkt.py:127", err,
           _time_ms(lambda: kkt.chol_inv_factor(P), reps),
           _time_ms(lambda: kkt.chol_inv_factor_plain(P), reps),
           bound(M * (dz ** 3 + 3 * dz * dz), 2 * M * dz * dz * es),
           _time_ms(lambda: _library_chol_inv(P), reps),
           f"{tol['K1']:.0e} relative, same NaN mask",
           shape=f"[{B},{N},{dz},{dz}] {dtype}", variant=variant)

    # -- K3: condensed factor and solve, [B, N] knots of dz columns, m rows
    # (_cr_accuracy: float64 to 1e-9, float32 against the plain version in
    # float64 on three seeds; _cr_nan: one indefinite dual block)
    label = f"[{B},{N},{dz},{dz}] m={m} {dtype}"
    (Pq, C, R, Cn, rhs), (Xi, fk), _, err_f, err_s, how = _cr_accuracy(
        B, N, dz, m, dtype, np.random.default_rng(22 if not f64 else 21), label)
    for seed in () if f64 else QD_F32_SEEDS:
        _cr_accuracy(B, N, dz, m, dtype, np.random.default_rng(seed), f"{label} seed {seed}")
    _cr_nan(B, N, dz, m, dtype)
    f_flops = B * (2 * N * m * dz * dz * 2 + N * m * m * dz * 2 * 3 + _cr_flops(Np, m))
    f_bytes = es * B * (N * dz * dz + N * m * dz + N * m + (N - 1) * m * dz
                        + 3 * Np * m * m)
    tol3 = "1e-9 relative" if f64 else \
        "float32: error vs plain float64 <= 2x plain float32's (seeds 22, 7, 1)"
    record("condensed_factor", "piccolax_torch/csrc/condensed_cr.cu",
           "piccolax/solver/kkt.py:445", err_f,
           _time_ms(lambda: kkt.condense_cr_factor(Xi, C, R, Cn), reps),
           _time_ms(lambda: kkt.condense_cr_factor_plain(Xi, C, R, Cn), reps),
           bound(f_flops, f_bytes), None,
           f"{tol3}; NaN mask of one indefinite dual block equal; timed from the "
           f"knot factors Xi (K1 excluded)",
           shape=f"B={B}, N={N}->{Np}, m={m}, dz={dz} {dtype}", variant=variant)
    s_flops = B * (N * 4 * dz * dz + N * 4 * m * dz * 2 + _cr_solve_flops(Np, m, 1))
    s_bytes = es * B * (N * dz * dz + N * m * dz + (N - 1) * m * dz
                        + 3 * Np * m * m + 2 * N * (dz + m))
    fp = kkt.condense_cr_factor_plain(Xi, C, R, Cn)
    record("condensed_solve", "piccolax_torch/csrc/cr_solve.cu",
           "piccolax/solver/kkt.py:464", err_s,
           _time_ms(lambda: kkt.condensed_solve((Xi, fk), C, Cn, rhs, dz), reps),
           _time_ms(lambda: kkt.condensed_solve_plain((Xi, fp), C, Cn, rhs, dz), reps),
           bound(s_flops, s_bytes), None, f"{tol3}; {how}",
           shape=f"rhs [{B},{N},{dz + m},1] {dtype}", variant=variant)
    if not k4:
        return

    # -- K4: expm on the line-search residual sweep [B * cand * ls, N-1, 4, 4]
    # (the derivative form: check_expm_derivatives)
    order = 12 if f64 else 8
    cand_ls, sq = (3 * 8, 1) if f64 else (2 * 6, 0)
    sysv = QuantumSystem(0.5 * PAULIS["Z"] if f64 else np.zeros((2, 2)),
                         [PAULIS["X"], PAULIS["Y"]] if f64 else
                         [PAULIS["X"] / 2, PAULIS["Y"] / 2],
                         1.0).solver_view().to(dev, dt_)
    dt = 0.1 if f64 else 10.0 / (N - 1)
    u = t(rng.uniform(-1, 1, (B * cand_ls, N - 1, 2)))
    Aexp = (dt * sysv.G(u)).contiguous()
    got = ex.expm_taylor_fixed(Aexp, order, sq)
    ref = ex.expm_taylor_fixed_plain(Aexp, order, sq)
    err, rel = _rel_err(got, ref)
    _check(rel < tol["K4"], f"expm_taylor_fixed ({dtype}) rel err {rel}")
    Mx = Aexp.numel() // 16
    record("expm_taylor_fixed", "piccolax_torch/csrc/expm_fixed.cu",
           "piccolax/ops/expm.py:143", err,
           _time_ms(lambda: ex.expm_taylor_fixed(Aexp, order, sq), reps),
           _time_ms(lambda: ex.expm_taylor_fixed_plain(Aexp, order, sq), reps),
           bound(Mx * _taylor_flops(4, order, sq), 2 * Mx * 16 * es),
           _time_ms(lambda: torch.linalg.matrix_exp(Aexp), reps),
           f"{tol['K4']:.0e} relative",
           shape=f"[{B * cand_ls},{N - 1},4,4] {dtype}, order {order}, s={sq}")


def check_expm_cnot(B, cand_ls, dtype, record, reps=5, pade_order=None):
    """Phase 3, K4 (or K6 with pade_order) at the CNOT's line-search
    residual sweep [B * cand_ls, N-1, 8, 8] (cand_ls = directions x
    ls_iters), at its integrator's order and squarings, against the plain
    version at the kernel's tolerance (K4: 1e-9 relative in float64, 1e-5
    in float32; K6: 1e-12 and 1e-5). (The derivative launches:
    check_expm_derivatives.)"""
    import torch
    import piccolax_torch as pt
    from piccolax_torch.ops import expm as ex

    dev = torch.device("cuda")
    dt_ = getattr(torch, dtype)
    f64 = dtype == "float64"
    es = 8 if f64 else 4
    rng = np.random.default_rng((61 if f64 else 62) + (0 if pade_order is None else 2))
    kw = {} if pade_order is None else {"pade_order": pade_order}
    prob = pt.cnot_problem(N=C3_N, T=C3_T, device="cuda", **kw)
    intg = prob.integrators[0]
    sysv = prob.qtraj.system.solver_view().to(dev, dt_)
    if pade_order is None:
        name, line = "expm_taylor_fixed", 143
        fn, plain = ex.expm_taylor_fixed, ex.expm_taylor_fixed_plain
        order, tol, flops = (12 if f64 else 8), (1e-9 if f64 else 1e-5), _taylor_flops
    else:
        name, line = "expm_pade_fixed", 105
        fn, plain = ex.expm_pade_fixed, ex.expm_pade_fixed_plain
        order, tol, flops = pade_order, (1e-12 if f64 else 1e-5), _pade_fixed_flops
    sq = intg.squarings
    dt = C3_T / (C3_N - 1)
    bound_u = prob.qtraj.system.drive_bounds[0][1]
    u = torch.as_tensor(rng.uniform(-bound_u, bound_u, (B * cand_ls, C3_N - 1, 4)),
                        dtype=dt_, device=dev)
    X = (dt * sysv.G(u)).contiguous()
    n = X.shape[-1]
    err, rel = _rel_err(fn(X, order, sq), plain(X, order, sq))
    _check(rel < tol, f"{name} CNOT residual sweep {tuple(X.shape)} ({dtype}) "
           f"rel err {rel:.3e}")
    Mx = X.numel() // (n * n)
    record(name, "piccolax_torch/csrc/expm_fixed.cu", f"piccolax/ops/expm.py:{line}", err,
           _time_ms(lambda: fn(X, order, sq), reps),
           _time_ms(lambda: plain(X, order, sq), reps),
           _bound(Mx * flops(n, order, sq), 2 * Mx * n * n * es, dtype),
           _time_ms(lambda: torch.linalg.matrix_exp(X), reps),
           f"{tol:.0e} relative",
           shape=f"CNOT residual sweep {list(X.shape)} {dtype}, order {order}, s={sq}",
           variant=f"config3_{dtype}_{n}x{n}")


def _path_directions(sysv, u, dt, dt_free):
    """A = dt G(u) [..., w, w] and the integrator's directions E [..., d, w, w]:
    dt G_k for each drive and, with a free timestep, G(u)."""
    import torch
    G = sysv.G(u)
    E = (dt * sysv.G_drives).expand(*G.shape[:-2], *sysv.G_drives.shape)
    if dt_free:
        E = torch.cat([E, G[..., None, :, :]], dim=-3)
    return (dt * G).contiguous(), E.contiguous()


def _structured_flops(w, d, order, sq):
    """Real operations of the derivative form on one knot, as the kernel
    does them: each step of the approximant (as _taylor_flops and
    _pade_fixed_flops count its products) takes 1 + 2d + 4 d (d + 1) / 2
    w x w block products (D, F_k, the pairs' S with four terms each) of w^3
    multiply-adds, and its elementwise work on every block of (D, F, S)."""
    if order == "taylor" or order in (8, 12):
        o = order if order in (8, 12) else None
        n_mm = (4 if o == 8 else 5) + sq
        elem = 17 if o == 8 else 24
    else:
        ev = (order - 1) // 2
        n_mm = ev + 14 + sq
        elem = 9 + 4 * ev
    blocks = 1 + d + d * (d + 1) // 2
    return n_mm * (1 + 2 * d + 2 * d * (d + 1)) * 2 * w ** 3 + elem * blocks * w * w


def _deriv_errors(got, ref):
    """The largest relative error of (Phi, dPhi, D2) against ref's, each
    over its own largest entry."""
    return max(_rel_err(g, r)[1] for g, r in zip(got, ref))


def _check_derivative_form(A, E, order, sq, label, tol64):
    """The derivative kernel on A, E: float64 against its plain version to
    tol64 relative; float32 against the plain version in float64 (the same
    approximant: Taylor order 8), at most twice the plain float32 version's
    error (or 1e-6). Where 3w <= 32, also against the dense kernel on the
    augmentations M: float64 to tol64, float32 to 1e-4 relative. Returns
    the error against the plain version (float32: against float64)."""
    import torch
    from piccolax_torch.ops import expm as ex
    got = ex.expm_fixed_derivatives(A, E, order, sq)
    torch.cuda.synchronize()
    if A.dtype == torch.float64:
        err = _deriv_errors(got, ex.expm_fixed_derivatives_plain(A, E, order, sq))
        _check(err < tol64, f"derivative form {label}: rel err {err:.3e} (tol {tol64:.0e})")
    else:
        ref = ex.expm_fixed_derivatives_plain(A.double(), E.double(), order, sq,
                                              taylor_order=8)
        err = _deriv_errors(got, ref)
        ep = _deriv_errors(ex.expm_fixed_derivatives_plain(A, E, order, sq), ref)
        _check(err <= max(2 * ep, 1e-6), f"derivative form {label} float32: rel err vs "
               f"float64 {err:.3e}, over twice the plain float32 version's {ep:.3e}")
    if 3 * A.shape[-1] <= 32:
        errd = _deriv_errors(got, ex.expm_fixed_derivatives_dense(A, E, order, sq))
        lim = tol64 if A.dtype == torch.float64 else 1e-4
        _check(errd < lim, f"derivative form {label}: rel diff vs the dense kernel on M "
               f"{errd:.3e} (tol {lim:.0e})")
    return err


# The paths' derivative launches: (label, B, N, dtype, order): the problem
# gives the system, the squaring count and whether dt is a direction.
DERIV_PATHS = [("config1", 256, 50, "float32", "taylor"),
               ("quickstart", 1, QS_N, "float64", "taylor"),
               ("quickstart_b256", QS_B, QS_N, "float64", "taylor"),
               ("quickstart_pade7", 1, QS_N, "float64", 7),
               ("quickstart_pade7_b256", QS_B, QS_N, "float64", 7),
               ("config3", C3_B, C3_N, "float32", "taylor"),
               ("cnot", 1, C3_N, "float64", "taylor")]
# directions' pairs: (w, d) up to the width cap, single and several tiles a
# knot (4 x 12, 8 x 8 and 16 x 5 split their pairs over thread blocks)
DERIV_SWEEP = [(1, 1), (2, 3), (3, 2), (5, 4), (6, 3), (7, 2), (9, 2), (10, 5), (12, 3),
               (16, 4), (16, 5), (4, 12), (8, 8)]


def _path_problem(label, N, order):
    """The problem of a derivative path: its system and its integrator."""
    import piccolax_torch as pt
    if label.startswith("config1"):
        prob = pt.sx_gate_problem(N=N, T=10.0, device="cuda")
        return prob.qtraj.system, prob.integrators[0], 10.0 / (N - 1)
    if label.startswith("quickstart"):
        sysq, _, qcp = _quickstart_problem(pade_order=order)
        return sysq, qcp.integrators[0], 0.1
    prob = pt.cnot_problem(N=N, T=C3_T, device="cuda")
    return prob.qtraj.system, prob.integrators[0], C3_T / (N - 1)


def check_expm_derivatives(record, reps=5):
    """Phase 3, the derivative form of K4 and K6 (one launch: r(A), its
    first derivatives along d directions and the symmetrised second ones):
    at every path's (w, d, order, s, dtype) on A = dt G(u) and the
    integrator's directions from the path's own system (u uniform in the
    drive bounds), float64 against the plain version to 1e-9 (K4) and
    1e-12 (K6) relative, float32 against the plain version in float64 (2x
    rule), and against the dense kernel on the augmentations; then Pade
    orders 3-9 and both Taylor orders at s 0 and 2, a sweep of (w, d) up
    to the width cap of 16 with knots whose pairs span several thread
    blocks, a refused w = 17, and the value form at every width 1-32."""
    import torch
    from piccolax_torch.ops import expm as ex

    rng = np.random.default_rng(17)
    dev = torch.device("cuda")
    for label, B, N, dtype, order in DERIV_PATHS:
        dt_ = getattr(torch, dtype)
        f64 = dtype == "float64"
        es = 8 if f64 else 4
        system, intg, dt = _path_problem(label, N, order)
        sq = intg.squarings
        sysv = system.solver_view().to(dev, dt_)
        bounds = np.asarray(system.drive_bounds, dtype=float)
        u = torch.as_tensor(rng.uniform(bounds[:, 0], bounds[:, 1],
                                        (B, N - 1, len(bounds))), dtype=dt_, device=dev)
        dt_free = label.startswith("quickstart")
        A, E = _path_directions(sysv, u, dt, dt_free)
        w, d = A.shape[-1], E.shape[-3]
        tol = 1e-9 if order == "taylor" else 1e-12
        err = _check_derivative_form(A, E, order, sq, label, tol)
        name = "expm_taylor_fixed_derivatives" if order == "taylor" else \
            "expm_pade_fixed_derivatives"
        M = B * (N - 1)
        flops = M * _structured_flops(w, d, (12 if f64 else 8) if order == "taylor" else order,
                                      sq)
        nbytes = M * es * w * w * (2 + 2 * d + d * d)
        Maug = ex.derivative_augmentations(A, E)
        record(name, "piccolax_torch/csrc/expm_fixed.cu",
               "piccolax/ops/expm.py:" + ("143" if order == "taylor" else "105"), err,
               _time_ms(lambda: ex.expm_fixed_derivatives(A, E, order, sq), reps),
               _time_ms(lambda: ex.expm_fixed_derivatives_plain(A, E, order, sq), reps),
               _bound(flops, nbytes, dtype),
               _time_ms(lambda: torch.linalg.matrix_exp(Maug), reps),
               f"{tol:.0e} relative (float64), float32: 2x the plain float32 version's "
               f"error vs float64; dense kernel on M agrees; library: matrix_exp on M",
               shape=f"{label} A [{B},{N - 1},{w},{w}], E d={d} {dtype}, order {order}, "
                     f"s={sq}", variant=label)
        del Maug

    def inside(lead, w, d, order, sq, dtype):
        radius = ex.TAYLOR_THETA if order == "taylor" else ex.pade_radius(order)
        A = rng.standard_normal((*lead, w, w))
        A *= 0.5 * radius * 2.0 ** sq / np.abs(A).sum(-1).max(-1)[..., None, None]
        E = 0.3 * radius * 2.0 ** sq * rng.standard_normal((*lead, d, w, w)) / w
        t = lambda x: torch.as_tensor(x, dtype=getattr(torch, dtype), device=dev)  # noqa: E731
        return t(A), t(E)

    errs = []
    for order in ("taylor", 3, 5, 7, 9):
        for sq in (0, 2):
            for dtype in ("float64", "float32"):
                A, E = inside((37,), 4, 3, order, sq, dtype)
                tol = 1e-9 if order == "taylor" else 1e-12
                errs.append(_check_derivative_form(A, E, order, sq,
                                                   f"order {order} s={sq} {dtype}", tol))
    for w, d in DERIV_SWEEP:
        for order, dtype in (("taylor", "float64"), (7, "float64"), ("taylor", "float32")):
            A, E = inside((23,), w, d, order, 1, dtype)
            tol = 1e-9 if order == "taylor" else 1e-12
            errs.append(_check_derivative_form(A, E, order, 1,
                                               f"w={w} d={d} order {order} {dtype}", tol))
    A, E = inside((2,), ex.MAX_DERIVATIVE_WIDTH + 1, 2, "taylor", 0, "float64")
    try:
        ex.expm_fixed_derivatives(A, E, "taylor", 0)
        _check(False, "expm_fixed_derivatives took a block wider than its cap")
    except ValueError:
        pass
    for n in range(1, 33):
        for dtype, tol in (("float64", 1e-12), ("float32", 1e-5)):
            A, _ = inside((29,), n, 1, 7, 1, dtype)
            for fn, plain, o in ((ex.expm_taylor_fixed, ex.expm_taylor_fixed_plain, None),
                                 (ex.expm_pade_fixed, ex.expm_pade_fixed_plain, 7)):
                rel = _rel_err(fn(A, o, 1) if o else fn(A, None, 1),
                               plain(A, o, 1) if o else plain(A, None, 1))[1]
                _check(rel < (1e-9 if o is None and dtype == "float64" else tol),
                       f"{fn.__name__} n={n} {dtype}: rel err {rel:.3e}")
    print(f"derivative form: orders (Taylor, Pade 3-9) x s (0, 2) x both types at w=4 "
          f"d=3, (w, d) sweep {DERIV_SWEEP} in float64 (Taylor, Pade 7) and float32, "
          f"max rel err {max(errs):.3e}; w={ex.MAX_DERIVATIVE_WIDTH + 1} refused; value "
          f"form at n = 1..32 (K4, K6, both types) within tolerance", flush=True)


def _taylor_flops(n, order, sq):
    """Real operations of K4 on one real n x n matrix, counted from its
    body: 3 products for X^2..X^4, 1 (order 8) or 2 (order 12) for the
    Paterson-Stockmeyer steps and sq squarings, 2n^3 - n^2 each; per entry
    the scaling and 16 (order 8) or 23 (order 12) for the cubics and sums."""
    n_mm = (4 if order == 8 else 5) + sq
    return n_mm * (2 * n ** 3 - n * n) + (17 if order == 8 else 24) * n * n


def _pade13_flops(n, s):
    """Real operations of K5 on one complex n x n matrix with s squarings
    (an int tensor), counted from its body: 23 + s complex products of
    8n^3 - 2n^2 (X^2, X^4, X^6; two for U and one for V; 16 in the 8
    Newton-Schulz steps; Y (V + U); s squarings), and elementwise 5n^2 - 1
    for the norm (a modulus as 4), 3 for s, 2n^2 to scale, 22n^2 + 2n
    each for U's and V's sums, 4n^2 for V -/+ U and 16n^2 for the 8 (2I - R).
    The 16 Newton-Schulz products are the algorithm's, not the function's:
    a pivoted solve would take about one product's work."""
    per_mm = 8 * n ** 3 - 2 * n * n
    return int(((23 + s.double()) * per_mm).sum().item()) \
        + s.numel() * (71 * n * n + 4 * n + 2)


def check_expm_pade13(record, reps=20):
    """Phase 3, K5: the rollout's Pade-13 expm against its plain version
    on the batched quickstart rollout [256 * 990, 2, 2] and on 4 x 4
    rollouts [16 * 199, 4, 4], complex128 and complex64, with every
    squaring count and norms within two ulps of each count's edge. Each
    matrix holds to tol relative for s <= 6 and tol * 2^(s-6) above (s
    squarings multiply a rounding difference by up to 2^s); the
    per-matrix s must agree."""
    import torch
    from piccolax_torch.ops import expm as ex

    rng = np.random.default_rng(5)
    main = None
    sub = {}
    for n, M in ((2, QS_B * (QS_N - 1) * 10), (4, 16 * 199)):
        for cdt, tol in ((np.complex128, 1e-12), (np.complex64, 1e-4)):
            A = torch.as_tensor(ex.anti_hermitian_by_squarings(M, n, rng, cdt),
                                device="cuda")
            got, s = ex.expm(A, return_squarings=True)
            ref = ex.expm_plain(A)
            s_ref = ex.pade13_squarings(A)
            _check(torch.equal(s, s_ref), f"expm {n}x{n} {cdt.__name__}: "
                   f"{int((s != s_ref).sum())} squaring counts differ")
            _check(set(s.unique().tolist()) == set(range(17)),
                   "expm inputs miss a squaring count")
            d = (got - ref).abs().amax(dim=(-2, -1))
            rel = d / ref.abs().amax(dim=(-2, -1))
            lim = tol * torch.pow(2.0, torch.clamp(s - 6, min=0).double())
            _check(bool((rel <= lim).all()), f"expm {n}x{n} {cdt.__name__} "
                   f"rel err {rel.max().item():.3e} above tol * 2^(s-6)")
            real = "float64" if cdt is np.complex128 else "float32"
            es = 16 if cdt is np.complex128 else 8
            flops = _pade13_flops(n, s)
            ms = _time_ms(lambda: ex.expm(A), reps)
            plain_ms = _time_ms(lambda: ex.expm_plain(A), reps)
            lib_ms = _time_ms(lambda: torch.linalg.matrix_exp(A), reps)
            b_ms, b_by = _bound(flops, 2 * M * n * n * es, real)
            key = f"[{M},{n},{n}] {cdt.__name__}"
            print(f"expm_pade13 {key}: max_err={d.max().item():.3e} "
                  f"(max rel {rel.max().item():.3e}; tol {tol:.0e} x 2^(s-6) "
                  f"above s=6), kernel_ms={ms:.4f}, plain_ms={plain_ms:.4f}, "
                  f"library_ms={lib_ms:.4f} (matrix_exp), bound_ms={b_ms:.4f} "
                  f"({b_by}), s 0..16 equal", flush=True)
            row = (d.max().item(), ms, plain_ms, (b_ms, b_by), lib_ms)
            if main is None:
                main = (key, row)
            else:
                sub[key] = {"max_abs_err": row[0], "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    key, (err, ms, plain_ms, bnd, lib_ms) = main
    record("expm_pade13", "piccolax_torch/csrc/expm_pade13.cu",
           "piccolax/ops/expm.py:74", err, ms, plain_ms, bnd, lib_ms,
           "1e-12 relative x 2^(s-6) above s=6, equal s", shape=key,
           extra={"variants": sub})


def _pade_fixed_flops(n, order, sq):
    """Real operations of K6 on one real n x n matrix, counted from its
    body: (order - 1) / 2 products for the even powers, 1 for U, 12 for
    the 6 Newton-Schulz steps, 1 for the numerator and sq squarings,
    2n^3 - n^2 each; per entry the scaling, 4 per even power for the sums
    of U and V, 2 for V -/+ U and 1 per Newton-Schulz step for 2I - R.
    The 12 Newton-Schulz products are the algorithm's, not the function's:
    a pivoted solve would take about one product's work."""
    ev = (order - 1) // 2
    return (ev + 14 + sq) * (2 * n ** 3 - n * n) + (9 + 4 * ev) * n * n


def check_expm_pade_fixed(record, reps=20):
    """Phase 3, K6: the fixed-order Pade expm against its plain version
    on the Pade quickstart's residuals [256 * 99, 4, 4] and derivative
    augmentations [256 * 99 * 9, 12, 12], orders 3, 5, 7 and 9, float64
    and float32, s in {0, 2}, every inf-norm at half the order's radius
    times 2^s (near order 9's radius of 2.1 the 6 Newton-Schulz steps do
    not converge on 4 x 4 matrices, in piccolax as here). Timed: order 7,
    s = 0 (the quickstart's), both sizes and types; the 4 x 4 float64 row
    is the kernel's record."""
    import torch
    from piccolax_torch.ops import expm as ex

    rng = np.random.default_rng(11)
    tol = {"float64": 1e-12, "float32": 1e-5}
    main, sub = None, {}
    for n, M in ((4, QS_B * (QS_N - 1)), (12, QS_B * (QS_N - 1) * 9)):
        A0 = rng.standard_normal((M, n, n))
        A0 /= np.abs(A0).sum(-1).max(-1)[:, None, None]      # inf-norm 1
        for real in ("float64", "float32"):
            dt_ = getattr(torch, real)
            es = 8 if real == "float64" else 4
            errs = []
            for order in (3, 5, 7, 9):
                for sq in (0, 2):
                    A = torch.as_tensor(0.5 * ex.pade_radius(order) * 2.0 ** sq * A0,
                                        dtype=dt_, device="cuda")
                    err, rel = _rel_err(ex.expm_pade_fixed(A, order, sq),
                                        ex.expm_pade_fixed_plain(A, order, sq))
                    _check(rel < tol[real], f"expm_pade_fixed order {order} s={sq} "
                           f"[{M},{n},{n}] {real}: rel err {rel:.3e}")
                    errs.append(err)
            A = torch.as_tensor(0.5 * ex.pade_radius(7) * A0, dtype=dt_, device="cuda")
            ms = _time_ms(lambda: ex.expm_pade_fixed(A, 7, 0), reps)
            plain_ms = _time_ms(lambda: ex.expm_pade_fixed_plain(A, 7, 0), reps)
            lib_ms = _time_ms(lambda: torch.linalg.matrix_exp(A), reps)
            b_ms, b_by = _bound(M * _pade_fixed_flops(n, 7, 0), 2 * M * n * n * es,
                                real)
            key = f"[{M},{n},{n}] {real}"
            print(f"expm_pade_fixed {key}: max_err={max(errs):.3e} (orders 3-9, "
                  f"s 0 and 2; tol {tol[real]:.0e} relative), order 7 s=0 "
                  f"kernel_ms={ms:.4f}, plain_ms={plain_ms:.4f}, library_ms="
                  f"{lib_ms:.4f} (matrix_exp), bound_ms={b_ms:.4f} ({b_by})",
                  flush=True)
            row = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
            if main is None:
                main = (key, row)
            else:
                sub[key] = row
    key, row = main
    record("expm_pade_fixed", "piccolax_torch/csrc/expm_fixed.cu",
           "piccolax/ops/expm.py:105", row["max_abs_err"], row["ms"],
           row["plain_ms"], (row["bound_ms"], row["bound_by"]), row["library_ms"],
           "1e-12 (f64) / 1e-5 (f32) relative, orders 3-9, s 0 and 2",
           shape=f"{key}, order 7, s=0", extra={"variants": sub})


def _qd_inputs(B, N, dz, m, dtype, rng, bad=None):
    """KKT blocks on the card (K7's and K9's checks): P PD (one indefinite
    block at bad = (problem, knot)), C and Cnext 0.3 N(0, 1), R 1e-3 as
    K3's check takes it, plus 1 at the last knot's empty rows. (With the
    float64 IPM's 1e-8 the N = 100 system's condition number amplifies
    rounding to ~1e-6 relative between any two implementations.)"""
    import torch
    X = rng.standard_normal((B, N, dz, dz))
    P = X @ np.swapaxes(X, -1, -2) / dz + \
        np.eye(dz) * rng.uniform(0.5, 5.0, (B, N, 1, 1))
    if bad is not None:
        P[bad] -= 20.0 * np.eye(dz)
    R = np.full((B, N, m), 1e-3)
    R[:, -1] += 1.0

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x),
                               dtype=getattr(torch, dtype), device="cuda")

    return (t(P), t(0.3 * rng.standard_normal((B, N, m, dz))), t(R),
            t(0.3 * rng.standard_normal((B, N - 1, m, dz))),
            t(rng.standard_normal((B, N, dz + m, 1))))


# float32 K7 seeds beyond the first (the first is check_qd's own)
QD_F32_SEEDS = (7, 1)


def _qd_accuracy(B, N, dz, m, dtype, rng, label):
    """K7 against its plain versions on healthy inputs from rng; returns
    the inputs, the kernel's and the plain factors, the largest absolute
    differences of the factors and the solve, and a note of the errors. float64: every result to 1e-9
    relative of the plain version's. float32: two float32 implementations
    round differently, so each result, the kernel's and the plain
    version's, is held against the plain version in float64 on the same
    inputs, and the kernel's relative error must be at most twice the
    plain version's (or 1e-6): the factors, the solve from them, and the
    solve alone (from the kernel's factors); the factor also to 1e-3
    relative of the plain float32 version's."""
    import torch
    from piccolax_torch.solver import kkt

    P, C, R, Cn, rhs = _qd_inputs(B, N, dz, m, dtype, rng)
    fk = kkt.qd_factor(P, C, R, Cn)
    fp = kkt.qd_factor_plain(P, C, R, Cn)
    xk = kkt.qd_solve(fk, C, Cn, rhs, dz)
    xp = kkt.qd_solve_plain(fp, C, Cn, rhs, dz)
    xo = kkt.qd_solve_plain(fk, C, Cn, rhs, dz)
    for a, what in ((fk[0], "Pinv"), (fk[1], "Sinv"), (xk, "solve")):
        _check(bool(torch.isfinite(a).all()), f"qd {what} {label} not finite")
    err_f = max(_rel_err(fk[i], fp[i])[0] for i in (0, 1))
    rel_f = max(_rel_err(fk[i], fp[i])[1] for i in (0, 1))
    err_s, rel_s = _rel_err(xk, xp)
    rel_o = _rel_err(xk, xo)[1]
    if dtype == "float64":
        for rel, what in ((rel_f, "factor"), (rel_s, "solve"),
                          (rel_o, "solve on its factors")):
            _check(rel < 1e-9, f"qd {what} {label} rel err {rel:.3e}")
        return (P, C, R, Cn, rhs), fk, fp, err_f, err_s, \
            f"{rel_s:.1e} relative, {rel_o:.1e} on the kernel's factors"
    _check(rel_f < 1e-3, f"qd factor {label} rel err {rel_f:.3e} vs plain float32")
    d = [x.double() for x in (P, C, R, Cn, rhs)]
    f64 = kkt.qd_factor_plain(*d[:4])
    x64 = kkt.qd_solve_plain(f64, d[1], d[3], d[4], dz)
    x64o = kkt.qd_solve_plain(tuple(f.double() for f in fk), d[1], d[3], d[4], dz)
    pairs = {"factor": (max(_rel_err(fk[i], f64[i])[1] for i in (0, 1)),
                        max(_rel_err(fp[i], f64[i])[1] for i in (0, 1))),
             "solve": (_rel_err(xk, x64)[1], _rel_err(xp, x64)[1]),
             "solve on its factors": (_rel_err(xk, x64o)[1], _rel_err(xo, x64o)[1])}
    for what, (k, pl) in pairs.items():
        _check(k <= max(2 * pl, 1e-6), f"qd {what} {label}: rel err vs float64 "
               f"{k:.3e}, over twice the plain float32 version's {pl:.3e}")
    vs64 = ", ".join(f"{w} {k:.2e} (plain {pl:.2e})" for w, (k, pl) in pairs.items())
    print(f"qd {label} vs float64: {vs64}; vs plain float32: factor {rel_f:.2e}, "
          f"solve {rel_s:.2e}, solve on its factors {rel_o:.2e}", flush=True)
    return (P, C, R, Cn, rhs), fk, fp, err_f, err_s, vs64


def check_qd(B, N, dz, m, dtype, record, reps=20, variant=None):
    """Phase 3, K7: the qd factor and solve against their plain versions
    at the shapes of a path (_qd_accuracy; float32 on three seeds); problem
    min(3, B - 1) has an indefinite P block at knot min(N // 2 + 1, N - 1),
    which must give NaN from that knot on in that problem only (the same
    [B, N] mask as the plain version) and leave the others finite. Timed
    on the first seed's inputs without the indefinite block."""
    import torch
    from piccolax_torch.solver import kkt

    f64 = dtype == "float64"
    es = 8 if f64 else 4
    rng = np.random.default_rng(21 if f64 else 22)
    pb, kb = min(3, B - 1), min(N // 2 + 1, N - 1)
    P, C, R, Cn, rhs = _qd_inputs(B, N, dz, m, dtype, rng, bad=(pb, kb))
    fk = kkt.qd_factor(P, C, R, Cn)
    fp = kkt.qd_factor_plain(P, C, R, Cn)
    for a, b_, what in ((fk[0], fp[0], "Pinv"), (fk[1], fp[1], "Sinv")):
        nan_k = torch.isnan(a).any(-1).any(-1)
        _check(torch.equal(nan_k, torch.isnan(b_).any(-1).any(-1)),
               f"qd_factor {what} ({dtype}): NaN mask differs from the plain version")
        want = torch.zeros_like(nan_k)
        want[pb, kb:] = True
        _check(torch.equal(nan_k, want), f"qd_factor {what} ({dtype}): NaN not "
               f"exactly in problem {pb} from knot {kb} on")
    xk = kkt.qd_solve(fk, C, Cn, rhs, dz)
    xp = kkt.qd_solve_plain(fp, C, Cn, rhs, dz)
    nan_s = torch.isnan(xk).flatten(1).any(1)
    _check(torch.equal(nan_s, torch.isnan(xp).flatten(1).any(1)),
           f"qd_solve ({dtype}): NaN mask differs from the plain version")
    _check(nan_s.sum().item() == 1 and bool(nan_s[pb]),
           f"qd_solve ({dtype}): NaN outside problem {pb}")
    _check(bool(torch.isfinite(xk[nan_s.logical_not()]).all()),
           f"qd_solve ({dtype}): non-finite values in healthy problems")

    label = f"[{B},{N},{dz},{dz}] m={m} {dtype}"
    (P, C, R, Cn, rhs), fk, fp, err_f, err_s, how = _qd_accuracy(
        B, N, dz, m, dtype, rng, f"{label} seed 22" if not f64 else label)
    for seed in () if f64 else QD_F32_SEEDS:
        _qd_accuracy(B, N, dz, m, dtype, np.random.default_rng(seed),
                     f"{label} seed {seed}")
    f_flops = B * N * (2 * m * m * dz + 4 * dz * dz * m + 2 * m * m * dz
                       + (8 * dz ** 3 + 8 * m ** 3) // 3 + 2 * m * m)
    f_bytes = es * B * (2 * N * dz * dz + N * m * dz + N * m + (N - 1) * m * dz
                        + N * m * m)
    s_flops = B * N * (6 * dz * dz + 10 * m * dz + 4 * m * m)
    s_bytes = es * B * (N * dz * dz + N * m * m + N * m * dz + (N - 1) * m * dz
                        + 2 * N * (dz + m))
    tol = "1e-9 relative" if f64 else \
        "float32: error vs plain float64 <= 2x plain float32's (seeds 22, 7, 1)"
    note = f"{tol}; NaN mask of one indefinite block equal"
    record("qd_factor", "piccolax_torch/csrc/qd.cu", "piccolax/solver/kkt.py:194",
           err_f, _time_ms(lambda: kkt.qd_factor(P, C, R, Cn), reps),
           _time_ms(lambda: kkt.qd_factor_plain(P, C, R, Cn), reps),
           _bound(f_flops, f_bytes, dtype), None, note,
           shape=f"B={B}, N={N}, dz={dz}, m={m} {dtype}", variant=variant)
    record("qd_solve", "piccolax_torch/csrc/qd.cu", "piccolax/solver/kkt.py:252",
           err_s, _time_ms(lambda: kkt.qd_solve(fk, C, Cn, rhs, dz), reps),
           _time_ms(lambda: kkt.qd_solve_plain(fp, C, Cn, rhs, dz), reps),
           _bound(s_flops, s_bytes, dtype), None, f"{note}; {how}",
           shape=f"rhs [{B},{N},{dz + m},1] {dtype}", variant=variant)


# (dz, m) of the width sweep: every pivot count of K7's Cholesky inverse
# (the width rounded up to 4 to 32, to 8 past it) in dz and in m, each
# register class (16, 32, 48, 64), and m above dz
QD_SWEEP = [(3, 2), (7, 5), (10, 9), (16, 13), (19, 17), (24, 21), (27, 25), (31, 30),
            (36, 33), (47, 41), (20, 36), (53, 50), (61, 57)]


def check_qd_widths(reps=5):
    """Phase 3, K7 at widths off the paths: [4, 20] problems and knots at
    each (dz, m) of QD_SWEEP (float64 up to its cap of 48), held as
    _qd_accuracy holds them; prints each factor's and solve's time."""
    from piccolax_torch.solver import kkt

    rng = np.random.default_rng(24)
    for dtype in ("float32", "float64"):
        for dz, m in QD_SWEEP:
            if dtype == "float64" and max(dz, m) > 48:
                continue
            label = f"[4,20,{dz},{dz}] m={m} {dtype}"
            (P, C, R, Cn, rhs), fk, _, err_f, err_s, _ = _qd_accuracy(
                4, 20, dz, m, dtype, rng, label)
            print(f"qd width sweep {label}: factor max_err={err_f:.3e} kernel_ms="
                  f"{_time_ms(lambda: kkt.qd_factor(P, C, R, Cn), reps):.4f}, solve "
                  f"max_err={err_s:.3e} kernel_ms="
                  f"{_time_ms(lambda: kkt.qd_solve(fk, C, Cn, rhs, dz), reps):.4f}",
                  flush=True)


# (dz, m) of the K1, K3 and K9 width sweep: each register class of
# chol_inv (16, 32, 48 and 64 wide) in dz (K1) and in m (K3, K9), the
# narrowest blocks and the cap
CR_SWEEP = [(3, 2), (24, 21), (36, 33), (61, 57), (64, 64)]


def check_cr_widths(reps=5):
    """Phase 3, K1, K3 and K9 at widths off the paths, float32 and float64,
    at each (dz, m) of CR_SWEEP: K1 on [4, 13] knot blocks against its
    plain version (1e-9 relative in float64, 1e-4 in float32, the same NaN
    mask); K3 at [4, 13] (Np = 16 > N) and K9 at [4, 24] with P = 4 (an
    interior of 4 knots) and P = 8 (of 1), as _cr_accuracy and _cr_nan
    hold them; prints each factor's time."""
    import torch
    from piccolax_torch.parallel import sharded_kkt as sk
    from piccolax_torch.solver import kkt

    rng = np.random.default_rng(26)
    for dtype in ("float32", "float64"):
        for dz, m in CR_SWEEP:
            Pm = _qd_inputs(4, 13, dz, m, dtype, rng)[0]
            Pm[1, 5] -= 20.0 * torch.eye(dz, dtype=Pm.dtype, device="cuda")
            got, ref = kkt.chol_inv_factor(Pm), kkt.chol_inv_factor_plain(Pm)
            _check(torch.equal(torch.isnan(got).any(-1).any(-1),
                               torch.isnan(ref).any(-1).any(-1)),
                   f"chol_inv_factor {dz} {dtype}: NaN mask differs")
            rel = _rel_err(got, ref)[1]
            _check(rel < (1e-9 if dtype == "float64" else 1e-4),
                   f"chol_inv_factor {dz} {dtype}: rel err {rel:.3e}")
            line = [f"K1 [4,13,{dz},{dz}] rel {rel:.1e}"]
            for N, P in ((13, None), (24, 4), (24, 8)):
                label = f"[4,{N},{dz},{dz}] m={m} {dtype}" + (f" P={P}" if P else "")
                (_, C, R, Cn, _), (Xi, fk), _, err_f, _, _ = _cr_accuracy(
                    4, N, dz, m, dtype, rng, label, P)
                _cr_nan(4, N, dz, m, dtype, P)
                fn = (lambda: kkt.condense_cr_factor(Xi, C, R, Cn)) if P is None else \
                    (lambda: sk.knot_condense_factor(Xi, C, R, Cn, P))
                line.append(f"{'K3' if P is None else f'K9 P={P}'} max_err={err_f:.2e} "
                            f"kernel_ms={_time_ms(fn, reps):.4f}")
            print(f"cr width sweep dz={dz} m={m} {dtype}: " + "; ".join(line), flush=True)


# K2's widths: n = 1 and each padding class (16, 32, 48, 64) at its edges
# and inside it
K2_SWEEP = [1, 2, 5, 9, 13, 16, 17, 24, 31, 32, 33, 40, 47, 48, 49, 57, 63, 64]


def check_k2_widths(reps=5):
    """Phase 3, K2 at widths off the paths: [37, n, n] (not a multiple of
    a thread block's blocks) for each n of K2_SWEEP, float32 (20 sweeps,
    floor 3e-3) and float64 (32 sweeps, 1e-6), modes "pos" and "abs":
    float64 to 1e-9 relative of the plain version, float32 to 1e-4 and
    against the plain version in float64 (2x rule); then block 3 holding
    a NaN, whose NaN mask must equal the plain version's (the other blocks
    finite), and block 5 made not exactly symmetric by one ulp (n > 1),
    which must come out all NaN, out of the kernels' contract, with the
    other blocks unchanged."""
    import torch
    from piccolax_torch.solver import kkt

    rng = np.random.default_rng(27)
    for dtype, iters, floor_rel in (("float32", 20, 3e-3), ("float64", 32, 1e-6)):
        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=getattr(torch, dtype),
                                   device="cuda")
        line = []
        for n in K2_SWEEP:
            W = _sym(rng, (37, n), t)
            for mode in ("pos", "abs"):
                rel = _rel_err(kkt.psd_clamp(W, floor_rel, iters, mode),
                               kkt.psd_clamp_plain(W, floor_rel, iters, mode))[1]
                _check(rel < (1e-9 if dtype == "float64" else 1e-4),
                       f"psd_clamp [37,{n},{n}] {dtype} ({mode}): rel err {rel:.3e}")
                if dtype == "float32":
                    _k2_vs_float64(W, floor_rel, iters, mode, f"[37,{n},{n}]")
            Wn = W.clone()
            Wn[3, n // 2, n - 1] = float("nan")
            got = kkt.psd_clamp(Wn, floor_rel, iters, "pos")
            ref = kkt.psd_clamp_plain(Wn, floor_rel, iters, "pos")
            _check(torch.equal(torch.isnan(got), torch.isnan(ref)),
                   f"psd_clamp [37,{n},{n}] {dtype}: NaN mask differs from the plain version")
            _check(bool(torch.isnan(got[3]).any()) and bool(torch.isfinite(got[:3]).all())
                   and bool(torch.isfinite(got[4:]).all()),
                   f"psd_clamp [37,{n},{n}] {dtype}: NaN not in block 3 alone")
            if n > 1:
                Wa = W.clone()
                Wa[5, 0, n - 1] = torch.nextafter(Wa[5, 0, n - 1], Wa.new_tensor(np.inf))
                got = kkt.psd_clamp(Wa, floor_rel, iters, "pos")
                ref = kkt.psd_clamp(W, floor_rel, iters, "pos")
                keep = torch.arange(37, device="cuda") != 5
                _check(bool(torch.isnan(got[5]).all()) and torch.equal(got[keep], ref[keep]),
                       f"psd_clamp [37,{n},{n}] {dtype}: a block not exactly symmetric "
                       f"did not come out all NaN alone")
            line.append(f"{n}: {rel:.1e} "
                        f"{_time_ms(lambda: kkt.psd_clamp(W, floor_rel, iters), reps):.4f} ms")
        print(f"psd_clamp width sweep {dtype} (n: rel err, kernel ms): " + ", ".join(line),
              flush=True)


# batches of K3's solve reaching every cluster size it launches with (16,
# 8, 4, 2, 1: the wrapper's choice, lowered where the card cannot hold all
# B clusters at once)
CR_SOLVE_BATCHES = (1, 2, 12, 16, 24, 64, 256)


def check_cr_solve_clusters(reps=5):
    """Phase 3, K3's solve at every cluster size: B of CR_SOLVE_BATCHES,
    N = 13 (short of 16) and N = 2, float64 at the quickstart's blocks
    (dz = 15, m = 13) and float32 at the CNOT's (44, 40), held as
    _cr_accuracy holds it (float64 to 1e-9, float32 against the plain
    version in float64, 2x rule); each solve call must count one
    condensed_solve launch, and every cluster size must have run."""
    from piccolax_torch import _kernels
    from piccolax_torch.solver import kkt

    rng = np.random.default_rng(28)
    lib = _kernels.load("cr_solve")
    ran = set()
    for dtype, dz, m in (("float64", 15, 13), ("float32", 44, 40)):
        for B in CR_SOLVE_BATCHES:
            S = lib.px_condensed_solve_cluster(int(dtype == "float64"), B, m, dz, 1)
            _check(S > 0, f"condensed_solve B={B} {dtype}: no launch plan")
            ran.add(S)
            line = []
            for N in (13, 2):
                label = f"[{B},{N},{dz},{dz}] m={m} {dtype}"
                (_, C, _, Cn, rhs), (Xi, fk), _, _, err_s, _ = _cr_accuracy(
                    B, N, dz, m, dtype, rng, label)
                before = _kernels.LAUNCHES["condensed_solve"]
                kkt.condensed_solve((Xi, fk), C, Cn, rhs, dz)
                _check(_kernels.LAUNCHES["condensed_solve"] == before + 1,
                       f"condensed_solve {label}: not one launch a call")
                ms = _time_ms(lambda: kkt.condensed_solve((Xi, fk), C, Cn, rhs, dz), reps)
                line.append(f"N={N} max_err={err_s:.2e} kernel_ms={ms:.4f}")
            print(f"cr solve B={B} {dtype} dz={dz} m={m}, cluster {S}: " + "; ".join(line),
                  flush=True)
    _check(ran >= {1, 2, 4, 8, 16}, f"condensed_solve ran cluster sizes {sorted(ran)} only")


def check_caps():
    """Phase 3: K7 and K8 on the card take exactly their stated widths
    (K7 64 in float32 and 48 in float64, as its library reports; K8 64)
    and raise ValueError past them, with no fallback."""
    import torch
    from piccolax_torch import _kernels
    from piccolax_torch.solver import kkt

    caps = [_kernels.load("qd").px_qd_max_width(f64) for f64 in (0, 1)]
    _check(caps == [64, 48], f"qd caps {caps}, stated 64 (float32) and 48 (float64)")
    rng = np.random.default_rng(23)
    refused = []
    for dtype, w in (("float32", 65), ("float64", 49)):
        P, C, R, Cn, rhs = _qd_inputs(1, 3, w, w, dtype, rng)
        for what, fn in (("qd_factor", lambda: kkt.qd_factor(P, C, R, Cn)),
                         ("qd_solve", lambda: kkt.qd_solve((P, P), C, Cn, rhs, w))):
            try:
                fn()
            except ValueError:
                refused.append(f"{what} {w} {dtype}")
                continue
            raise RuntimeError(f"{what} took width {w} in {dtype}")
    try:
        kkt.tri_lower_inv(torch.eye(65, device="cuda").expand(2, 65, 65).contiguous())
        raise RuntimeError("tri_lower_inv took width 65")
    except ValueError:
        refused.append("tri_lower_inv 65")
    print(f"caps: K7 {caps[0]} (float32), {caps[1]} (float64), K8 {kkt._MAX_M}; "
          f"refused: {', '.join(refused)}", flush=True)


def check_tri_lower_inv(record, reps=20):
    """Phase 3, K8: the lower-triangular inverse (on no solve path) against
    its plain version at [25600, m, m], m = 32, 16, 44 and 64, float64 and
    float32, on Cholesky factors of SPD matrices; relative to
    max |L^{-1}|, since substitution and doubling round differently. The
    [25600, 32, 32] float64 row is the kernel's record. Operations from
    the body: column j takes 2(i - j) + 1 per row i >= j, m(m+1)(2m+1)/6
    in all; bytes: the sectors of L's lower triangle read, the whole
    m x m inverse written."""
    import torch
    from piccolax_torch.solver import kkt

    rng = np.random.default_rng(31)
    tol = {"float64": 1e-12, "float32": 1e-5}
    main, sub = None, {}
    for m in (32, 16, 44, 64):
        X = rng.standard_normal((25600, m, m))
        L0 = np.linalg.cholesky(X @ np.swapaxes(X, -1, -2) / m + np.eye(m))
        for real in ("float64", "float32"):
            L = torch.as_tensor(L0, dtype=getattr(torch, real), device="cuda")
            es = 8 if real == "float64" else 4
            err, rel = _rel_err(kkt.tri_lower_inv(L), kkt.tri_lower_inv_plain(L))
            _check(rel < tol[real], f"tri_lower_inv [25600,{m},{m}] {real}: "
                   f"rel err {rel:.3e}")
            eye = torch.eye(m, dtype=L.dtype, device="cuda").expand_as(L)
            ms = _time_ms(lambda: kkt.tri_lower_inv(L), reps)
            plain_ms = _time_ms(lambda: kkt.tri_lower_inv_plain(L), reps)
            lib_ms = _time_ms(lambda: torch.linalg.solve_triangular(
                L, eye, upper=False), reps)
            b_ms, b_by = _bound(25600 * m * (m + 1) * (2 * m + 1) // 6,
                                25600 * (_lower_tri_bytes(m, es) + m * m * es), real)
            key = f"[25600,{m},{m}] {real}"
            if main is None:
                main = (key, err, ms, plain_ms, (b_ms, b_by), lib_ms)
            else:
                print(f"tri_lower_inv {key}: max_err={err:.3e} ({tol[real]:.0e} "
                      f"relative), kernel_ms={ms:.4f}, plain_ms={plain_ms:.4f}, "
                      f"library_ms={lib_ms:.4f} (solve_triangular), "
                      f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
                sub[key] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    key, err, ms, plain_ms, bnd, lib_ms = main
    record("tri_lower_inv", "piccolax_torch/csrc/tri_inv.cu",
           "piccolax/solver/kkt.py:58", err, ms, plain_ms, bnd, lib_ms,
           "1e-12 (f64) / 1e-5 (f32) relative to max |L^-1|", shape=key,
           extra={"variants": sub})


def _cr_flops(Np, m):
    """Operations of the CR level loop (K3, K9) on Np rows of m x m
    blocks: Np Cholesky inverses (m^3 + 3 m^2 each) and 5 products of
    2 m^3 per eliminated row."""
    return Np * (m ** 3 + 3 * m * m) + (Np - 1) * 5 * 2 * m ** 3


def _cr_solve_flops(Np, m, r):
    """Operations of one CR solve of r columns on Np rows: 6 products of
    2 m^2 per eliminated row and column, 2 m^2 at the root."""
    return ((Np - 1) * 12 + 2) * m * m * r


def _knot_counts(N, P, m, r):
    """Operations of K9's partitioned part, shared by the factor and the
    standalone solve, from the kernels' bodies: (factor, solve) per
    problem. Factor: each partition's interior CR (k rows padded to Npk),
    its SPIKE solve of 2m columns and 3 interface products, then the
    interface CR (2P rows padded to Npi). Solve of r columns: the interior
    solves, r_f and r_l, the interface solve and x_int."""
    from piccolax_torch.solver.kkt import _pow2_pad
    k = N // P - 2
    Npk, Npi = _pow2_pad(k), _pow2_pad(2 * P)
    factor = P * (_cr_flops(Npk, m) + _cr_solve_flops(Npk, m, 2 * m)
                  + 3 * 2 * m ** 3) + _cr_flops(Npi, m)
    solve = P * (_cr_solve_flops(Npk, m, r) + 2 * 2 * m * m * r
                 + k * 2 * 2 * m * m * r) + _cr_solve_flops(Npi, m, r)
    return factor, solve, (Npk, Npi, k)


def _cr_factors(Xi, C, R, Cn, P=None, kernel=True):
    """K3's (P None) or K9's (P partitions) factor of the condensed KKT
    from the knot factors Xi, by the kernel (kernel) or the plain version:
    (factor planes by name, solve of rhs given the factor)."""
    from piccolax_torch.parallel import sharded_kkt as sk
    from piccolax_torch.solver import kkt
    dz = Xi.shape[-1]
    if P is None:
        f = (kkt.condense_cr_factor if kernel else kkt.condense_cr_factor_plain)(Xi, C, R, Cn)
        return {"Xi": Xi, "cr": f}, lambda f_, rhs, k=kernel: (
            kkt.condensed_solve if k else kkt.condensed_solve_plain)(
                (f_["Xi"], f_["cr"]), C, Cn, rhs, dz)
    f = (sk.knot_condense_factor if kernel else sk.knot_condense_factor_plain)(
        Xi, C, R, Cn, P)
    return f, lambda f_, rhs, k=kernel: (
        sk.knot_condensed_solve if k else sk.knot_condensed_solve_plain)(f_, rhs, P, dz)


CR_PLANES = ("cr", "fT", "spike", "Ub", "f_if")


def _cr_accuracy(B, N, dz, m, dtype, rng, label, P=None):
    """K3's (P None) or K9's factor and solve against their plain versions
    on healthy inputs from rng (_qd_inputs), both from the same knot
    factors Xi of K1 (K1 is held by its own check). float64: every factor
    plane, the solve and the solve on the kernel's factors to 1e-9
    relative of the plain version's. float32: each, the kernel's and the
    plain float32 version's, is held against the plain version in float64
    on the same inputs (Xi cast to float64), and the kernel's relative
    error must be at most twice the plain version's (or 1e-6). Returns the
    inputs, (Xi, the kernel's factor), the plain factor, the largest
    absolute differences of the factor and the solve from the plain
    version, and a note of the errors."""
    import torch
    from piccolax_torch.solver import kkt
    what = "knot" if P else "condensed"
    Pm, C, R, Cn, rhs = _qd_inputs(B, N, dz, m, dtype, rng)
    Xi = kkt.chol_inv_factor(Pm)
    fk, solve_k = _cr_factors(Xi, C, R, Cn, P)
    fp, solve_p = _cr_factors(Xi, C, R, Cn, P, kernel=False)
    planes = [k for k in CR_PLANES if k in fk]
    xk, xp = solve_k(fk, rhs), solve_p(fp, rhs)
    xo = solve_p(fk, rhs)                       # the plain solve on the kernel's factors
    for a, name in [(fk[k], k) for k in planes] + [(xk, "solve")]:
        _check(bool(torch.isfinite(a).all()), f"{what} {name} {label} not finite")
    err_f = max(_rel_err(fk[k], fp[k])[0] for k in planes)
    rel_f = max(_rel_err(fk[k], fp[k])[1] for k in planes)
    err_s, rel_s = _rel_err(xk, xp)
    rel_o = _rel_err(xk, xo)[1]
    main = fk["cr"] if P is None else fk
    if dtype == "float64":
        for rel, name in ((rel_f, "factor"), (rel_s, "solve"), (rel_o, "solve on its factors")):
            _check(rel < 1e-9, f"{what} {name} {label} rel err {rel:.3e}")
        return (Pm, C, R, Cn, rhs), (Xi, main), fp, err_f, err_s, \
            f"{rel_s:.1e} relative, {rel_o:.1e} on the kernel's factors"
    d = [x.double() for x in (Xi, C, R, Cn, rhs)]
    f64, solve64 = _cr_factors(*d[:4], P, kernel=False)
    x64 = solve64(f64, d[4])
    x64o = solve64({k: v.double() for k, v in fk.items()}, d[4])
    pairs = {"factor": (max(_rel_err(fk[k], f64[k])[1] for k in planes),
                        max(_rel_err(fp[k], f64[k])[1] for k in planes)),
             "solve": (_rel_err(xk, x64)[1], _rel_err(xp, x64)[1]),
             "solve on its factors": (_rel_err(xk, x64o)[1], _rel_err(xo, x64o)[1])}
    for name, (k, pl) in pairs.items():
        _check(k <= max(2 * pl, 1e-6), f"{what} {name} {label}: rel err vs float64 "
               f"{k:.3e}, over twice the plain float32 version's {pl:.3e}")
    vs64 = ", ".join(f"{w} {k:.2e} (plain {pl:.2e})" for w, (k, pl) in pairs.items())
    print(f"{what} {label} vs float64: {vs64}; vs plain float32: factor {rel_f:.2e}, "
          f"solve {rel_s:.2e}, solve on its factors {rel_o:.2e}", flush=True)
    return (Pm, C, R, Cn, rhs), (Xi, main), fp, err_f, err_s, vs64


def _cr_nan(B, N, dz, m, dtype, P=None):
    """K3's (P None) or K9's factor and solve, from K1's knot factors, with
    one indefinite dual block: problem min(3, B - 1), at an odd knot (K3:
    eliminated at the first level) or at the second interior knot of the
    second partition (K9; the first where there is one), its R row -1e4.
    Every factor plane's NaN mask (any NaN in a block) must equal the
    plain version's on the same Xi, the solve's NaN must be in that
    problem alone, and every other problem's factor and solution finite."""
    import torch
    from piccolax_torch.solver import kkt
    pb = min(3, B - 1)
    kb = 2 * (N // 4) + 1 if P is None else N // P + 1 + min(1, N // P - 3)
    Pm, C, R, Cn, rhs = _qd_inputs(B, N, dz, m, dtype, np.random.default_rng(25))
    R[pb, kb] = -1e4
    Xi = kkt.chol_inv_factor(Pm)
    fk, solve_k = _cr_factors(Xi, C, R, Cn, P)
    fp, solve_p = _cr_factors(Xi, C, R, Cn, P, kernel=False)
    label = f"{'knot P=%d' % P if P else 'condensed'} [{B},{N},{dz},{dz}] m={m} {dtype}"
    for k in (k for k in CR_PLANES if k in fk):
        nk, npl = torch.isnan(fk[k]).any(-1).any(-1), torch.isnan(fp[k]).any(-1).any(-1)
        _check(torch.equal(nk, npl), f"{label}: {k} NaN mask differs from the plain version")
        others = torch.ones(B, dtype=torch.bool, device=nk.device)
        others[pb] = False
        _check(bool(torch.isfinite(fk[k][others]).all()), f"{label}: {k} not finite "
               f"outside problem {pb}")
    nan_s = torch.isnan(solve_k(fk, rhs)).flatten(1).any(1)
    _check(torch.equal(nan_s, torch.isnan(solve_p(fp, rhs)).flatten(1).any(1)),
           f"{label}: solve NaN mask differs from the plain version")
    _check(bool(nan_s[pb]) and int(nan_s.sum()) == 1, f"{label}: solve NaN not in "
           f"problem {pb} alone")


def check_knot(B, N, dz, m, dtype, record, reps=5):
    """Phase 3, K9: the knot-partitioned condensed factor (from K1's knot
    factors Xi, as K3's factor row is timed) and solve against their plain
    versions at the shapes of a path, P = 8 and 4 partitions, as
    _cr_accuracy holds them (float32 on three seeds) and with one
    indefinite dual block (_cr_nan); the solution also against K3's plain
    condensed solve ("cr"), 1e-9 relative in float64, 1e-3 in float32."""
    import torch
    from piccolax_torch.parallel import sharded_kkt as sk
    from piccolax_torch.solver import kkt

    f64 = dtype == "float64"
    es = 8 if f64 else 4
    tol = "1e-9 relative" if f64 else \
        "float32: error vs plain float64 <= 2x plain float32's (seeds 42, 7, 1)"
    for P in (8, 4):
        label = f"[{B},{N},{dz},{dz}] m={m} {dtype} P={P}"
        (Pm, C, R, Cn, rhs), (Xi, fk), fp, err_f, err_s, how = _cr_accuracy(
            B, N, dz, m, dtype, np.random.default_rng(41 if f64 else 42), label, P)
        for seed in () if f64 else QD_F32_SEEDS:
            _cr_accuracy(B, N, dz, m, dtype, np.random.default_rng(seed),
                         f"{label} seed {seed}", P)
        _cr_nan(B, N, dz, m, dtype, P)
        x_cr = kkt.condensed_solve_plain((Xi, kkt.condense_cr_factor_plain(Xi, C, R, Cn)),
                                         C, Cn, rhs, dz)
        xk = sk.knot_condensed_solve(fk, rhs, P, dz)
        _, rel_cr = _rel_err(xk, x_cr)
        _check(rel_cr < (1e-9 if f64 else 1e-3),
               f"knot solve P={P} ({dtype}) vs cr rel err {rel_cr:.3e}")
        fac, sol, (Npk, Npi, k) = _knot_counts(N, P, m, 1)
        f_flops = B * (2 * N * m * dz * dz * 2 + N * m * m * dz * 2 * 3 + fac)
        fact_bytes = P * (3 * Npk * m * m + k * 2 * m * m + 2 * m * m) + 3 * Npi * m * m
        f_bytes = es * B * (N * dz * dz + N * m * dz + N * m + (N - 1) * m * dz
                            + fact_bytes)
        s_flops = B * (N * (8 * dz * dz + 8 * m * dz) + sol)
        s_bytes = es * B * (N * dz * dz + N * m * dz + (N - 1) * m * dz + fact_bytes
                            + 2 * N * (dz + m))
        variant = f"P={P}, B={B} {dtype}"
        record("knot_factor", "piccolax_torch/csrc/knot.cu",
               "piccolax/parallel/sharded_kkt.py:149", err_f,
               _time_ms(lambda: sk.knot_condense_factor(Xi, C, R, Cn, P), reps),
               _time_ms(lambda: sk.knot_condense_factor_plain(Xi, C, R, Cn, P), reps),
               _bound(f_flops, f_bytes, dtype), None,
               f"{tol} on every factor plane; NaN mask of one indefinite dual block "
               f"equal; timed from the knot factors Xi (K1 excluded)",
               shape=f"B={B}, N={N}, P={P}, m={m}, dz={dz} {dtype}", variant=variant)
        record("knot_solve", "piccolax_torch/csrc/knot.cu",
               "piccolax/parallel/sharded_kkt.py:194", err_s,
               _time_ms(lambda: sk.knot_condensed_solve(fk, rhs, P, dz), reps),
               _time_ms(lambda: sk.knot_condensed_solve_plain(fp, rhs, P, dz), reps),
               _bound(s_flops, s_bytes, dtype), None,
               f"{tol}; {how}; also against cr ({rel_cr:.1e})",
               shape=f"rhs [{B},{N},{dz + m},1], P={P} {dtype}", variant=variant)


def _dense_tridiag(diag, upper):
    """The dense [B, N m, N m] matrix of block-tridiagonal systems."""
    import torch
    B, N, m, _ = diag.shape
    S = diag.new_zeros(B, N, m, N, m)
    idx = torch.arange(N)
    S[:, idx, :, idx, :] = diag.transpose(0, 1)
    S[:, idx[:-1], :, idx[1:], :] = upper.transpose(0, 1)
    S[:, idx[1:], :, idx[:-1], :] = upper.mT.transpose(0, 1)
    return S.reshape(B, N * m, N * m)


def check_knot_tridiag(record, reps=20):
    """Phase 3, K9's standalone block-tridiagonal solve (on no solve path):
    tests/test_multichip.py's systems (diag A A^T + 4m I, upper N(0, 1)) at
    [1, 48, 5, 5] (sharded_spd_tridiag_solve) and [4, 48, 5, 5]
    (batched_sharded_spd_tridiag_solve), two right-hand sides, P = 8 and 4,
    float64, 1e-9 relative to the plain version and to a dense Cholesky
    solve; the library column is torch.linalg.cholesky + cholesky_solve of
    the assembled dense (N m)^2 matrices."""
    import torch
    from piccolax_torch.parallel import sharded_kkt as sk

    rng = np.random.default_rng(51)
    N, m, r = 48, 5, 2
    for B in (1, 4):
        A = rng.standard_normal((B, N, m, m))
        diag = torch.as_tensor(A @ np.swapaxes(A, -1, -2) + 4 * m * np.eye(m),
                               device="cuda")
        upper = torch.as_tensor(rng.standard_normal((B, N - 1, m, m)), device="cuda")
        rhs = torch.as_tensor(rng.standard_normal((B, N, m, r)), device="cuda")
        S = _dense_tridiag(diag, upper)
        b_flat = rhs.reshape(B, N * m, r)
        ref = torch.cholesky_solve(b_flat, torch.linalg.cholesky(S)).reshape(rhs.shape)
        for P in (8, 4):
            if B == 1:
                fn = lambda: sk.sharded_spd_tridiag_solve(diag[0], upper[0], rhs[0], P)  # noqa: E731
                fn_p = lambda: sk.sharded_spd_tridiag_solve_plain(diag[0], upper[0], rhs[0], P)  # noqa: E731
            else:
                fn = lambda: sk.batched_sharded_spd_tridiag_solve(diag, upper, rhs, P)  # noqa: E731
                fn_p = lambda: sk.batched_sharded_spd_tridiag_solve_plain(diag, upper, rhs, P)  # noqa: E731
            got, plain = fn().reshape(rhs.shape), fn_p().reshape(rhs.shape)
            err, rel = _rel_err(got, plain)
            _check(rel < 1e-9, f"knot tridiag B={B} P={P} rel err {rel:.3e}")
            _, rel_d = _rel_err(got, ref)
            _check(rel_d < 1e-9, f"knot tridiag B={B} P={P} vs dense rel err {rel_d:.3e}")
            fac, sol, _ = _knot_counts(N, P, m, r)
            flops = B * (fac + sol)
            nbytes = 8 * B * (N * m * m + (N - 1) * m * m + 2 * N * m * r)
            name = "sharded_spd_tridiag_solve" if B == 1 else \
                "batched_sharded_spd_tridiag_solve"
            record("knot_tridiag_solve", "piccolax_torch/csrc/knot.cu",
                   "piccolax/parallel/sharded_kkt.py:64", err, _time_ms(fn, reps),
                   _time_ms(fn_p, reps), _bound(flops, nbytes, "float64"),
                   _time_ms(lambda: torch.cholesky_solve(
                       b_flat, torch.linalg.cholesky(S)), reps),
                   f"1e-9 relative, also against the dense solve ({rel_d:.1e}); "
                   f"library: cholesky + cholesky_solve of [{B},{N * m},{N * m}]",
                   shape=f"{name} [{B},{N},{m},{m}], r={r}, P={P} float64",
                   variant=f"{name}, P={P}")


def _eigh_clamp(W, floor_rel):
    import torch
    ew, V = torch.linalg.eigh(W)
    return (V * torch.clamp(ew, min=0)[..., None, :]) @ V.mT + \
        floor_rel * torch.eye(W.shape[-1], device=W.device, dtype=W.dtype)


def _library_chol_inv(A):
    import torch
    L, _ = torch.linalg.cholesky_ex(A)
    eye = torch.eye(A.shape[-1], device=A.device, dtype=A.dtype).expand_as(A)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def _read_launches(path, required, forbidden=()):
    """The launch counts of a path's run: every kernel of `required` was
    launched, none of `forbidden` (the path must not fall back), and K4's
    and K6's value form never on a 12- or 24-wide block (the dense
    augmentations: the derivative form carries them)."""
    from piccolax_torch import _kernels
    launches = dict(_kernels.LAUNCHES)
    print(f"{path} launches: {json.dumps(launches)}; K4 and K6 by block width: "
          f"{json.dumps(_kernels.WIDTHS)}", flush=True)
    for k in required:
        _check(launches[k] > 0, f"kernel {k} was not launched on the {path} path")
    for k in forbidden:
        _check(launches[k] == 0, f"kernel {k} was launched on the {path} path")
    for k in ("expm_taylor_fixed", "expm_pade_fixed"):
        for n in (12, 24):
            _check(_kernels.WIDTHS.get(f"{k} {n}", 0) == 0,
                   f"{k} ran on {n}-wide augmentations on the {path} path")
    return launches


# the KKT kernels of each backend (K1 factors the knot blocks of "cr")
_KKT_KERNELS = {"cr": ["chol_inv_factor", "condensed_factor", "condensed_solve"],
                "qd": ["qd_factor", "qd_solve"]}
# K4 and K6, each in its value form (residuals, line search) and its
# derivative form (one launch a derivatives evaluation)
TAYLOR_KERNELS = ["expm_taylor_fixed", "expm_taylor_fixed_derivatives"]
PADE_KERNELS = ["expm_pade_fixed", "expm_pade_fixed_derivatives"]


def config1(B, N, T, kkt_backend="cr"):
    """Phase 4 (and 9 with kkt_backend "qd"): config 1 through the port's
    entry points, on the card."""
    import torch
    import piccolax_torch as pt
    from piccolax_torch import _kernels
    from piccolax_torch.quantum.gates import GATES
    from piccolax_torch.verification import (batched_unitary_dop853,
                                             iso_vec_to_operator_np,
                                             unitary_fidelity_np)

    prob = pt.sx_gate_problem(N=N, T=T, device="cuda")
    nlp, params, Z0, g0, layout = prob.build(device="cuda")
    u_sl = layout.slices["u"]
    rng = np.random.default_rng(0)
    Zb = np.broadcast_to(Z0.cpu().numpy().astype(np.float32)[None],
                         (B, N, layout.z_dim)).copy()
    Zb[:, :, u_sl] += 0.02 * rng.standard_normal(
        (B, N, u_sl.stop - u_sl.start)).astype(np.float32)
    Zb = torch.as_tensor(Zb, device="cuda")
    opts = pt.IPMOptions(max_iter=60, tol=5e-3, constr_viol_tol=5e-3,
                         ls_iters=6, clamp_iters=15, kkt_backend=kkt_backend)
    pt.solve_nlp(nlp, params, Zb, device="cuda",        # warm-up, 2 iterations
                 options=pt.IPMOptions(**{**opts.__dict__, "max_iter": 2}))
    _kernels.reset_launch_counts()
    _sync()
    t0 = time.perf_counter()
    st = pt.solve_nlp(nlp, params, Zb, options=opts, device="cuda")
    _sync()
    seconds = time.perf_counter() - t0
    iters = int(st.it.max().item())
    label = "config-1" if kkt_backend == "cr" else f"config-1-{kkt_backend}"
    launches = _read_launches(label, ["psd_clamp", "expm_taylor_fixed",
                                      "expm_taylor_fixed_derivatives",
                                      *_KKT_KERNELS[kkt_backend]],
                              [*_KKT_KERNELS["qd" if kkt_backend == "cr" else "cr"],
                               *PADE_KERNELS])
    its = st.it.cpu().numpy()
    print(f"{label}: B={B} N={N} f32, kkt_backend {kkt_backend}, {iters} "
          f"iterations (max; mean {its.mean():.2f}, min {its.min()}), "
          f"{seconds:.3f} s, {B / seconds:.2f} solves/s; per IPM iteration: "
          + json.dumps({k: round(v / iters, 2) for k, v in launches.items()}),
          flush=True)

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
    return launches, (nlp, params, Zb, opts)


def _quickstart_problem(device="cuda", pade_order="taylor"):
    """docs/quickstart.py steps 1-4 (system, pulse, trajectory, problem),
    with the collocation propagator of `pade_order`."""
    import piccolax_torch as pt
    sysq = pt.QuantumSystem(0.5 * pt.PAULIS["Z"], [pt.PAULIS["X"], pt.PAULIS["Y"]],
                            1.0)
    times = np.linspace(0.0, QS_T, QS_N)
    rng = np.random.default_rng(0)
    pulse = pt.ZeroOrderPulse(0.1 * rng.standard_normal((QS_N, 2)), times)
    qtraj = pt.UnitaryTrajectory(sysq, pulse, pt.GATES["X"], device=device)
    qcp = pt.SmoothPulseProblem(qtraj, QS_N, Q=100.0, R=1e-2, ddu_bound=1.0,
                                dt_bounds=(0.05, 0.2), pade_order=pade_order)
    return sysq, qtraj, qcp


# The default quickstart path ("taylor", "cr") and the Pade/qd one
# (pade_order=7, kkt_backend="qd"): the kernels each must launch and those
# it must not (no fallback to the other path's kernels).
QS_PATHS = {
    ("taylor", "cr"): (["chol_inv_factor", "psd_clamp", "condensed_factor",
                        "condensed_solve", *TAYLOR_KERNELS, "expm_pade13"],
                       [*PADE_KERNELS, "qd_factor", "qd_solve"]),
    (7, "qd"): (["psd_clamp", *PADE_KERNELS, "qd_factor", "qd_solve", "expm_pade13"],
                ["chol_inv_factor", "condensed_factor", "condensed_solve",
                 *TAYLOR_KERNELS]),
}


def _qs_options(kkt_backend):
    import piccolax_torch as pt
    return pt.IPMOptions(max_iter=150, tol=1e-7, constr_viol_tol=1e-7,
                         kkt_backend=kkt_backend)


def quickstart(pade_order="taylor", kkt_backend="cr"):
    """Phase 5 (and 7 with pade_order=7, kkt_backend="qd"): the quickstart
    flow, steps 1-5, in float64 on the card."""
    import piccolax_torch as pt
    from piccolax_torch import _kernels

    label = "quickstart" if pade_order == "taylor" else \
        f"quickstart-pade{pade_order}-{kkt_backend}"
    required, forbidden = QS_PATHS[(pade_order, kkt_backend)]
    _kernels.reset_launch_counts()
    _sync()
    t0 = time.perf_counter()
    sysq, qtraj, qcp = _quickstart_problem(pade_order=pade_order)
    F0 = float(qtraj.fidelity())
    qcp.solve(max_iter=150, tol=1e-7, verbose=True, device="cuda",
              options=_qs_options(kkt_backend))
    F = float(qcp.fidelity())
    tt = qcp.traj.get_times()
    F_roll = float(pt.unitary_rollout_fidelity(
        sysq, qcp.traj["u"], tt, pt.GATES["X"], interpolation="constant",
        device="cuda"))
    _sync()
    wall = time.perf_counter() - t0
    launches = _read_launches(label, required, forbidden)
    iters = int(qcp.result.it)
    dF = abs(F - F_roll)
    print(f"{label}: N={QS_N} T={QS_T} f64, pade_order {pade_order}, "
          f"kkt_backend {kkt_backend}, initial F={F0:.6f}, {iters} "
          f"iterations, converged={qcp.converged}, stalled={qcp.stalled}, "
          f"wall {wall:.3f} s (construction, solve, sync, rollout check), "
          f"F={F:.9f}, F_roll={F_roll:.9f}, |dF|={dF:.3e}; per IPM iteration: "
          + json.dumps({k: round(v / iters, 2) for k, v in launches.items()}),
          flush=True)
    _check(F > 0.999, f"{label} fidelity {F} <= 0.999")
    _check(dF < 1e-5, f"{label} |F - F_roll| = {dF} >= 1e-5")
    return launches


def quickstart_batched(gate, pade_order="taylor", kkt_backend="cr"):
    """Phase 6 (and 8 with pade_order=7, kkt_backend="qd"): the quickstart
    problem at B = 256 (pulses perturbed by 0.02 N(0, 1), as bench.py
    does) in one batched float64 solve with the Newton candidate, then one
    batched rollout (10 substeps) of all extracted pulses through one K5
    launch."""
    import torch
    import piccolax_torch as pt
    from piccolax_torch import _kernels
    from piccolax_torch.quantum.dynamics import unitary_fidelity_iso

    label = "batched-quickstart" if pade_order == "taylor" else \
        f"batched-quickstart-pade{pade_order}-{kkt_backend}"
    required, forbidden = QS_PATHS[(pade_order, kkt_backend)]
    sysq, _, qcp = _quickstart_problem(pade_order=pade_order)
    nlp, params, Z0, _, lay = qcp.build(device="cuda")
    u, dsl, Usl = lay.slices["u"], lay.slices["dt"], lay.slices["U"]
    rng = np.random.default_rng(0)
    Zb = np.broadcast_to(Z0.cpu().numpy()[None], (QS_B, *Z0.shape)).copy()
    Zb[:, :, u] += 0.02 * rng.standard_normal((QS_B, QS_N, u.stop - u.start))
    Zb = torch.as_tensor(Zb, device="cuda")
    opts = _qs_options(kkt_backend)
    pt.solve_nlp(nlp, params, Zb, device="cuda",        # warm-up, 2 iterations
                 options=pt.IPMOptions(**{**opts.__dict__, "max_iter": 2}))
    _kernels.reset_launch_counts()
    _sync()
    t0 = time.perf_counter()
    st = pt.solve_nlp(nlp, params, Zb, options=opts, device="cuda")
    _sync()
    t_solve = time.perf_counter() - t0
    Z = st.Z
    dts = Z[:, :, dsl.start]
    times = torch.cat([torch.zeros_like(dts[:, :1]), torch.cumsum(dts[:, :-1], 1)], 1)
    F_roll = pt.unitary_rollout_fidelity(sysq, Z[:, :, u], times, pt.GATES["X"],
                                         interpolation="constant")
    _sync()
    t_total = time.perf_counter() - t0
    launches = _read_launches(label, required, forbidden)
    goal = params["goal"]["U"]
    F_rep = unitary_fidelity_iso(Z[:, -1, Usl], goal)
    F_roll, F_rep = F_roll.cpu().numpy(), F_rep.cpu().numpy()
    iters = int(st.it.max().item())
    n_conv = int(st.converged.sum().item())
    n_stall = int(st.stalled.sum().item())
    frac = float(np.mean(F_roll > 0.999))
    dF = np.abs(F_rep - F_roll)
    print(f"{label}: B={QS_B} N={QS_N} f64, pade_order {pade_order}, "
          f"kkt_backend {kkt_backend}, {iters} iterations (max), "
          f"solve {t_solve:.3f} s, {QS_B / t_solve:.2f} solves/s, with the "
          f"rollout {t_total:.3f} s; converged={n_conv}/{QS_B}, "
          f"stalled={n_stall}/{QS_B}, F_roll mean={F_roll.mean():.6f} "
          f"min={F_roll.min():.6f}, frac_F_roll>0.999={frac:.4f}, "
          f"mean|dF|={dF.mean():.2e}; per IPM iteration: "
          + json.dumps({k: round(v / iters, 2) for k, v in launches.items()}),
          flush=True)
    _check(bool(torch.isfinite(Z).all()) and np.all(np.isfinite(F_roll)),
           f"{label}: non-finite results")
    _check(frac >= gate, f"{label}: frac_F_roll>0.999 {frac} < {gate}")
    return launches, (nlp, params, Zb, opts)




def _c3_options(**kw):
    import piccolax_torch as pt
    return pt.IPMOptions(**{**dict(max_iter=150, tol=5e-3, constr_viol_tol=5e-3,
                                   hess_mode="abs", delta_c_f32=1e-4, prox_iter=3),
                            **kw})


def _cnot_fidelities(prob, us, Z, u_sl, U_sl):
    """Float64 DOP853 re-integration of pulses us [B, N, 4] with the
    problem's own Hamiltonians (the independent rollout gate), and the
    solver's final-knot fidelity from Z [B, N, dz]."""
    from piccolax_torch.verification import (batched_unitary_dop853,
                                             iso_vec_to_operator_np,
                                             unitary_fidelity_np)
    sysq, goal = prob.qtraj.system, prob.qtraj.goal
    times = np.linspace(0, C3_T, C3_N)
    U64 = batched_unitary_dop853(sysq.H_drift, np.stack(sysq.H_drives), us, times,
                                 rtol=1e-10, atol=1e-10)
    Fs = unitary_fidelity_np(U64, goal)
    F_rep = unitary_fidelity_np(iso_vec_to_operator_np(Z[:, -1, U_sl]), goal)
    return Fs, np.abs(F_rep - Fs)


# the kernels of the config-3 and the CNOT-knot paths, and those they must not launch
C3_KERNELS = ["chol_inv_factor", "psd_clamp", "condensed_factor", "condensed_solve",
              *TAYLOR_KERNELS]
KNOT_KERNELS = ["chol_inv_factor", "psd_clamp", "knot_factor", "knot_solve",
                *TAYLOR_KERNELS]
OFF_PATH = ["qd_factor", "qd_solve", *PADE_KERNELS, "tri_lower_inv",
            "knot_tridiag_solve"]
# the CNOT on "qd" (phase 12): K7 instead of K1 and K3 (and no K9)
C3_QD_KERNELS = ["psd_clamp", "qd_factor", "qd_solve", *TAYLOR_KERNELS]
C3_QD_FORBIDDEN = ["chol_inv_factor", "condensed_factor", "condensed_solve",
                   "knot_factor", "knot_solve", *PADE_KERNELS, "tri_lower_inv",
                   "knot_tridiag_solve"]


def config3(kkt_backend="cr"):
    """Phase 10 (and 12 with kkt_backend "qd"): config 3, the CNOT
    (N = 200, T = 50), through the port's entry points at B = 16 in
    float32, pulse columns of Z0 perturbed by 0.002 N(0, 1) (seed 0) as
    bench.py does; gated by float64 DOP853 F > 0.999 on all 16."""
    import torch
    import piccolax_torch as pt
    from piccolax_torch import _kernels

    prob = pt.cnot_problem(N=C3_N, T=C3_T, device="cuda")
    nlp, params, Z0, _, layout = prob.build(device="cuda")
    u_sl, U_sl = layout.slices["u"], layout.slices["U"]
    rng = np.random.default_rng(0)
    Zb = np.broadcast_to(Z0.cpu().numpy().astype(np.float32)[None],
                         (C3_B, C3_N, layout.z_dim)).copy()
    Zb[:, :, u_sl] += 0.002 * rng.standard_normal(
        (C3_B, C3_N, u_sl.stop - u_sl.start)).astype(np.float32)
    Zb = torch.as_tensor(Zb, device="cuda")
    opts = _c3_options(kkt_backend=kkt_backend)
    pt.solve_nlp(nlp, params, Zb, device="cuda",
                 options=_c3_options(max_iter=2, kkt_backend=kkt_backend))
    _kernels.reset_launch_counts()
    _sync()
    t0 = time.perf_counter()
    st = pt.solve_nlp(nlp, params, Zb, options=opts, device="cuda")
    _sync()
    seconds = time.perf_counter() - t0
    label = "config-3" if kkt_backend == "cr" else f"config-3-{kkt_backend}"
    if kkt_backend == "cr":
        launches = _read_launches(label, C3_KERNELS,
                                  ["knot_factor", "knot_solve", *OFF_PATH])
    else:
        launches = _read_launches(label, C3_QD_KERNELS, C3_QD_FORBIDDEN)
    its = st.it.cpu().numpy()
    iters = int(its.max())
    print(f"{label}: B={C3_B} N={C3_N} f32, kkt_backend {kkt_backend}, hess_mode abs, "
          f"{iters} iterations (max; mean {its.mean():.2f}, min {its.min()}), "
          f"{seconds:.3f} s, {C3_B / seconds:.3f} solves/s; per IPM iteration: "
          + json.dumps({k: round(v / iters, 2) for k, v in launches.items()}),
          flush=True)
    Z = st.Z.double().cpu().numpy()
    _check(np.all(np.isfinite(Z)) and Z.shape == (C3_B, C3_N, layout.z_dim),
           f"{label} solution not finite or of shape {Z.shape}")
    t1 = time.perf_counter()
    Fs, dF = _cnot_fidelities(prob, Z[:, :, u_sl], Z, u_sl, U_sl)
    n_conv = int(st.converged.sum().item())
    print(f"{label} quality: converged={n_conv}/{C3_B}, f64-DOP853 mean_F="
          f"{Fs.mean():.6f}, min_F={Fs.min():.6f}, F>0.999 on "
          f"{int((Fs > 0.999).sum())}/{C3_B}, mean|dF|={dF.mean():.2e}, "
          f"max|dF|={dF.max():.2e}, dop853 {time.perf_counter() - t1:.1f} s",
          flush=True)
    _check(bool(np.all(Fs > 0.999)), f"{label}: F > 0.999 on "
           f"{int((Fs > 0.999).sum())}/{C3_B} only")
    return launches, (nlp, params, Zb, opts)


def cnot_knot():
    """Phase 11: the CNOT at B = 1 in float64 on kkt_backend "knot" with
    P = 4 and 8 partitions: max_iter 40 each beside "cr" from the same Z0
    (the same it, Z to rtol 1e-7 / atol 1e-9, kkt_err to rtol 1e-4, as
    tests/test_multichip.py holds piccolax's "knot" against "cr"), then one
    P = 8 solve to its end (max_iter 250, tol 1e-6), gated by DOP853
    F > 0.999."""
    import torch
    import piccolax_torch as pt
    from piccolax_torch import _kernels

    prob = pt.cnot_problem(N=C3_N, T=C3_T, device="cuda")
    nlp, params, Z0, _, layout = prob.build(device="cuda")
    u_sl, U_sl = layout.slices["u"], layout.slices["U"]
    runs = {}
    for backend, P in (("cr", None), *(("knot", P) for P in KNOT_PARTS)):
        opts = pt.IPMOptions(max_iter=40, tol=1e-6, constr_viol_tol=1e-6,
                             kkt_backend=backend)
        _kernels.reset_launch_counts()
        _sync()
        t0 = time.perf_counter()
        st = pt.solve_nlp(nlp, params, Z0, options=opts, mesh=P, device="cuda")
        _sync()
        seconds = time.perf_counter() - t0
        label = "cnot-cr-40" if P is None else f"cnot-knot-P{P}-40"
        if P is None:
            cr_launches = _read_launches(label, C3_KERNELS,
                                         ["knot_factor", "knot_solve", *OFF_PATH])
        else:
            _read_launches(label, KNOT_KERNELS,
                           ["condensed_factor", "condensed_solve", *OFF_PATH])
        runs[P] = st
        print(f"{label}: B=1 N={C3_N} f64, {int(st.it)} iterations, {seconds:.3f} s "
              f"({1e3 * seconds / int(st.it):.1f} ms per iteration), kkt_err "
              f"{float(st.kkt_err):.6e}", flush=True)
    ref = runs[None]
    for P in KNOT_PARTS:
        st = runs[P]
        _check(int(st.it) == int(ref.it), f"knot P={P}: it {int(st.it)} "
               f"against cr's {int(ref.it)}")
        dZ = (st.Z - ref.Z).abs()
        _check(bool((dZ <= 1e-9 + 1e-7 * ref.Z.abs()).all()),
               f"knot P={P}: Z differs from cr by up to {dZ.max().item():.3e}")
        dk = abs(float(st.kkt_err) - float(ref.kkt_err))
        _check(dk <= 1e-4 * abs(float(ref.kkt_err)),
               f"knot P={P}: kkt_err differs from cr by {dk:.3e}")
        print(f"cnot-knot-P{P} vs cr (max_iter 40): same it, max|dZ| "
              f"{dZ.max().item():.3e}, |d kkt_err| {dk:.3e}", flush=True)

    P = max(KNOT_PARTS)
    opts = pt.IPMOptions(max_iter=250, tol=1e-6, constr_viol_tol=1e-6,
                         kkt_backend="knot")
    _kernels.reset_launch_counts()
    _sync()
    t0 = time.perf_counter()
    st = pt.solve_nlp(nlp, params, Z0, options=opts, mesh=P, device="cuda")
    _sync()
    seconds = time.perf_counter() - t0
    label = f"cnot-knot-P{P}"
    launches = _read_launches(label, KNOT_KERNELS,
                              ["condensed_factor", "condensed_solve", *OFF_PATH])
    iters = int(st.it)
    Z = st.Z[None].double().cpu().numpy()
    _check(np.all(np.isfinite(Z)), f"{label}: solution not finite")
    Fs, dF = _cnot_fidelities(prob, Z[:, :, u_sl], Z, u_sl, U_sl)
    print(f"{label}: B=1 N={C3_N} f64, {iters} iterations, converged="
          f"{bool(st.converged)}, stalled={bool(st.stalled)}, {seconds:.3f} s "
          f"({1e3 * seconds / iters:.1f} ms per iteration), f64-DOP853 "
          f"F={Fs[0]:.9f}, |dF|={dF[0]:.3e}; per IPM iteration: "
          + json.dumps({k: round(v / iters, 2) for k, v in launches.items()}),
          flush=True)
    _check(Fs[0] > 0.999, f"{label}: F {Fs[0]} <= 0.999")
    return launches, dict(nlp=nlp, params=params, Z0=Z0, cr40=ref, prob=prob,
                          layout=layout, cr_launches=cr_launches)


def cnot_qd(run_k):
    """Phase 12, second part: the CNOT at B = 1 in float64 on kkt_backend
    "qd": max_iter 40 from phase 11's Z0, reported beside phase 11's "cr"
    run of the same length (it, kkt_err, the largest Z difference), then
    one solve to its end (max_iter 250, tol 1e-6), gated by DOP853
    F > 0.999."""
    import piccolax_torch as pt
    from piccolax_torch import _kernels

    nlp, params, Z0, ref, prob = (run_k[k] for k in ("nlp", "params", "Z0", "cr40",
                                                       "prob"))
    u_sl, U_sl = run_k["layout"].slices["u"], run_k["layout"].slices["U"]
    launches = None
    for max_iter in (40, 250):
        opts = pt.IPMOptions(max_iter=max_iter, tol=1e-6, constr_viol_tol=1e-6,
                             kkt_backend="qd")
        _kernels.reset_launch_counts()
        _sync()
        t0 = time.perf_counter()
        st = pt.solve_nlp(nlp, params, Z0, options=opts, device="cuda")
        _sync()
        seconds = time.perf_counter() - t0
        label = f"cnot-qd-{max_iter}" if max_iter == 40 else "cnot-qd"
        launches = _read_launches(label, C3_QD_KERNELS, C3_QD_FORBIDDEN)
        iters = int(st.it)
        if max_iter == 40:
            dZ = (st.Z - ref.Z).abs().max().item()
            print(f"{label}: B=1 N={C3_N} f64, {iters} iterations, {seconds:.3f} s "
                  f"({1e3 * seconds / iters:.1f} ms per iteration), kkt_err "
                  f"{float(st.kkt_err):.6e}; cr (phase 11): {int(ref.it)} iterations, "
                  f"kkt_err {float(ref.kkt_err):.6e}; max|Z_qd - Z_cr| {dZ:.3e}",
                  flush=True)
            continue
        Z = st.Z[None].double().cpu().numpy()
        _check(np.all(np.isfinite(Z)), f"{label}: solution not finite")
        Fs, dF = _cnot_fidelities(prob, Z[:, :, u_sl], Z, u_sl, U_sl)
        print(f"{label}: B=1 N={C3_N} f64, {iters} iterations, converged="
              f"{bool(st.converged)}, stalled={bool(st.stalled)}, {seconds:.3f} s "
              f"({1e3 * seconds / iters:.1f} ms per iteration), f64-DOP853 "
              f"F={Fs[0]:.9f}, |dF|={dF[0]:.3e}; per IPM iteration: "
              + json.dumps({k: round(v / iters, 2) for k, v in launches.items()}),
              flush=True)
        _check(Fs[0] > 0.999, f"{label}: F {Fs[0]} <= 0.999")
    return launches


def profile(name, fn, iters=None):
    """Run fn under torch.profiler: wall, device busy time and idle share of
    the profiled run, and device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
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
    per = "" if not iters else \
        f", {1e3 * busy / 1e6 / iters:.2f} ms of device time per iteration"
    print(f"profile {name}: wall {wall:.3f} s (profiled), device busy "
          f"{busy / 1e6:.3f} s, idle share {1 - busy / 1e6 / wall:.3f} of the "
          f"profiled run, {len(events)} device events{per}", flush=True)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=20)
    print(table, flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile config 1 and the four quickstart solves")
    ap.add_argument("--profile-cnot", action="store_true",
                    help="also profile 20 iterations of config 3 and of the "
                         "CNOT on cr and on knot")
    ap.add_argument("--profile-qd", action="store_true",
                    help="also profile 20 iterations of every qd path: the Pade/qd "
                         "quickstart at B = 1 and 256, config 1 and config 3 on "
                         "qd, and the CNOT on qd")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import piccolax_torch as pt  # noqa: F401  (fails outside a checkout)
    from piccolax_torch import _kernels

    card = _card()
    print(card, flush=True)
    t0 = time.perf_counter()
    _kernels.build()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

    rows = {}

    def record(name, source, replaces, err, ms, plain_ms, bound, library_ms,
               tol, shape, extra=None, variant=None):
        bound_ms, bound_by = bound
        lib = "none (no single PyTorch call)" if library_ms is None \
            else f"{library_ms:.4f}"
        print(f"{name} {shape}: max_err={err:.3e} ({tol}), kernel_ms={ms:.4f}, "
              f"plain_ms={plain_ms:.4f}, library_ms={lib}, "
              f"bound_ms={bound_ms:.4g} ({bound_by})", flush=True)
        row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms, "shape": shape, **(extra or {})}
        if name in rows:                # the float64 quickstart or another variant
            rows[name][variant or "float64_quickstart"] = row
            return
        rows[name] = {"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": 0, **row}

    check_kernels(256, 50, 14, 12, "float32", record)
    check_kernels(QS_B, QS_N, 15, 13, "float64", record, reps=5)
    check_expm_pade13(record)
    check_expm_pade_fixed(record, reps=5)
    check_qd(256, 50, 14, 12, "float32", record)
    check_qd(QS_B, QS_N, 15, 13, "float64", record, reps=5)
    check_qd(1, QS_N, 15, 13, "float64", record, variant="float64_quickstart_b1")
    check_qd(C3_B, C3_N, 44, 40, "float32", record, reps=5, variant="config3_float32")
    check_qd(1, C3_N, 44, 40, "float64", record, reps=5, variant="config3_float64")
    check_qd(2, 20, 64, 64, "float32", record, reps=5, variant="cap_float32")
    check_qd(2, 20, 48, 48, "float64", record, reps=5, variant="cap_float64")
    check_qd(4, 1, 15, 13, "float64", record, reps=5, variant="N1_float64")
    check_qd(4, 2, 14, 12, "float32", record, reps=5, variant="N2_float32")
    check_qd_widths()
    check_cr_widths()
    check_k2_widths()
    check_cr_solve_clusters()
    check_caps()
    check_tri_lower_inv(record, reps=5)
    check_kernels(C3_B, C3_N, 44, 40, "float32", record, reps=5, clamp=(20, 3e-3),
                  k4=False, variant="config3_float32")
    check_kernels(1, C3_N, 44, 40, "float64", record, reps=5, k4=False,
                  variant="config3_float64")
    # phase 10: B = 16, f32, no Newton candidate (2 directions x 8 steps);
    # phase 11: B = 1, f64, with it (3 x 8)
    check_expm_cnot(C3_B, 2 * 8, "float32", record)
    check_expm_cnot(1, 3 * 8, "float64", record)
    check_expm_cnot(C3_B, 2 * 8, "float32", record, pade_order=7)
    check_expm_cnot(1, 3 * 8, "float64", record, pade_order=7)
    check_expm_derivatives(record)
    check_knot(1, C3_N, 44, 40, "float64", record)
    check_knot(C3_B, C3_N, 44, 40, "float32", record)
    check_knot_tridiag(record)

    paths = {}
    paths["config1"], run1 = config1(256, 50, 10.0)
    paths["quickstart"] = quickstart()
    paths["quickstart_b256"], run_b = quickstart_batched(gate=0.9)
    paths["quickstart_pade7_qd"] = quickstart(pade_order=7, kkt_backend="qd")
    paths["quickstart_pade7_qd_b256"], run_pq = quickstart_batched(
        gate=0.9, pade_order=7, kkt_backend="qd")
    paths["config1_qd"], run1q = config1(256, 50, 10.0, kkt_backend="qd")
    paths["config3"], run3 = config3()
    paths[f"cnot_knot_p{max(KNOT_PARTS)}"], run_k = cnot_knot()
    paths["cnot_cr_40"] = run_k["cr_launches"]
    paths["config3_qd"], run3q = config3(kkt_backend="qd")
    paths["cnot_qd"] = cnot_qd(run_k)
    if args.profile:
        profile("config 1 solve (B=256, f32)",
                lambda: pt.solve_nlp(*run1[:3], options=run1[3], device="cuda"))
        _, _, qcp = _quickstart_problem()
        profile("quickstart solve (B=1, f64)",
                lambda: qcp.solve(max_iter=150, tol=1e-7, verbose=False,
                                  device="cuda"))
        profile("batched quickstart solve (B=256, f64)",
                lambda: pt.solve_nlp(*run_b[:3], options=run_b[3], device="cuda"))
        _, _, qcp7 = _quickstart_problem(pade_order=7)
        profile("Pade/qd quickstart solve (B=1, f64)",
                lambda: qcp7.solve(verbose=False, device="cuda",
                                   options=_qs_options("qd")))
        profile("batched Pade/qd quickstart solve (B=256, f64)",
                lambda: pt.solve_nlp(*run_pq[:3], options=run_pq[3], device="cuda"))
    if args.profile_cnot:
        nlp3, params3, Zb3, _ = run3
        profile("config 3, 20 iterations (B=16, f32, cr)",
                lambda: pt.solve_nlp(nlp3, params3, Zb3, device="cuda",
                                     options=_c3_options(max_iter=20)))
        nlpk, paramsk, Z0k = run_k["nlp"], run_k["params"], run_k["Z0"]
        for backend, P in (("cr", None), ("knot", max(KNOT_PARTS))):
            profile(f"CNOT, 20 iterations (B=1, f64, {backend}, P={P})",
                    lambda: pt.solve_nlp(nlpk, paramsk, Z0k, mesh=P, device="cuda",
                                         options=pt.IPMOptions(
                                             max_iter=20, kkt_backend=backend)))
    if args.profile_qd:
        def window(run, n=20):
            return lambda: pt.solve_nlp(*run[:3], device="cuda", options=pt.IPMOptions(
                **{**run[3].__dict__, "max_iter": n}))
        _, _, qcp7 = _quickstart_problem(pade_order=7)
        profile("Pade/qd quickstart, 20 iterations (B=1, f64)",
                lambda: qcp7.solve(verbose=False, device="cuda", options=pt.IPMOptions(
                    **{**_qs_options("qd").__dict__, "max_iter": 20})), 20)
        profile("batched Pade/qd quickstart, 20 iterations (B=256, f64)",
                window(run_pq), 20)
        profile("config 1 on qd, 20 iterations (B=256, f32)", window(run1q), 20)
        profile("config 3 on qd, 20 iterations (B=16, f32)", window(run3q), 20)
        profile("CNOT on qd, 20 iterations (B=1, f64)",
                lambda: pt.solve_nlp(run_k["nlp"], run_k["params"], run_k["Z0"],
                                     device="cuda", options=pt.IPMOptions(
                                         max_iter=20, tol=1e-6, constr_viol_tol=1e-6,
                                         kkt_backend="qd")), 20)
    for name, r in rows.items():
        r["launches_by_path"] = {p: c[name] for p, c in paths.items()}
        r["launches"] = sum(r["launches_by_path"].values())
    print(card, flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
