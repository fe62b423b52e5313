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
   every squaring count 0..16;
4. config 1: the SX gate (N = 50, T = 10) at B = 256 in float32, gated
   with a float64 DOP853 re-integration;
5. quickstart: docs/quickstart.py steps 1-5 (N = 100, T = 10, free
   timesteps) through the port's entry points in float64, B = 1;
6. batched quickstart: the same problem at B = 256 with perturbed pulses
   in one batched float64 solve, then one batched rollout of every
   extracted pulse.

Each of 4-6 resets every launch counter just before it and reads them
just after, and fails if a kernel of its path was not launched. Prints
the {"kernels": [...]} record, then as the last line {"ok": true,
"device": {...}}. Exits nonzero, with no result line, without a card or
when any phase fails. ``--profile`` also profiles config 1 and both
quickstart solves.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, 700 W): outside the tensor cores
H100_FLOPS = {"float32": 67e12, "float64": 34e12}
H100_BYTES_PER_S = 3.35e12  # HBM3

QS_N, QS_T, QS_B = 100, 10.0, 256


def _check(ok, message):
    """A failed check ends the run (kept under python -O, unlike assert)."""
    if not ok:
        raise RuntimeError(message)


def _bound(flops, nbytes, real="float32"):
    t_ops = flops / H100_FLOPS[real]
    t_bytes = nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


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


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[0]


def check_kernels(B, N, dz, m, dtype, record, reps=20):
    """Phase 3, K1-K4: every kernel against its plain version at the
    shapes of a path: B problems of N knots, dz columns, m rows; K4 on the
    line-search residual sweep and on the derivative augmentations."""
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
           "K3": 1e-9 if f64 else 1e-3, "K4": 1e-9 if f64 else 1e-5}

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt_, device=dev)

    def bound(flops, nbytes):
        return _bound(flops, nbytes, dtype)

    # -- K2: psd_clamp on symmetric indefinite knot Hessians [B, N, dz, dz]
    W = rng.standard_normal((B, N, dz, dz))
    W = t(0.5 * (W + np.swapaxes(W, -1, -2)))
    iters, floor_rel = (32, 1e-6) if f64 else (15, 3e-3)
    errs = {}
    for mode in ("pos", "abs"):
        got = kkt.psd_clamp(W, floor_rel, iters, mode)
        ref = kkt.psd_clamp_plain(W, floor_rel, iters, mode)
        errs[mode], rel = _rel_err(got, ref)
        _check(rel < tol["K2"], f"psd_clamp({mode}, {dtype}) rel err {rel}")
    M = B * N
    flops = M * (iters * 4 * dz ** 3 + 2 * dz ** 3 + 6 * dz * dz)
    # the row describes mode "pos", the one the main paths run
    record("psd_clamp", "piccolax_torch/csrc/psd_clamp.cu",
           "piccolax/solver/kkt.py:150", errs["pos"],
           _time_ms(lambda: kkt.psd_clamp(W, floor_rel, iters, "pos"), reps),
           _time_ms(lambda: kkt.psd_clamp_plain(W, floor_rel, iters, "pos"), reps),
           bound(flops, 2 * M * dz * dz * es),
           _time_ms(lambda: _eigh_clamp(W, floor_rel), reps),
           f"{tol['K2']:.0e} relative, mode pos; mode abs max_err={errs['abs']:.3e}",
           shape=f"[{B},{N},{dz},{dz}] {dtype}, {iters} sweeps")

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
           shape=f"[{B},{N},{dz},{dz}] {dtype}")

    # -- K3: condensed factor and solve, [B, N] knots of dz columns, m rows
    C = t(0.3 * rng.standard_normal((B, N, m, dz)))
    Cn = t(0.3 * rng.standard_normal((B, N - 1, m, dz)))
    R = np.full((B, N, m), 1e-3)
    R[:, -1] += 1.0
    R = t(R)
    fk = kkt.condensed_factor(P, C, R, Cn)
    fp = kkt.condensed_factor_plain(P, C, R, Cn)
    err_f, rel = _rel_err(fk[1], fp[1])
    _check(rel < tol["K3"], f"condensed_factor ({dtype}) rel err {rel}")
    rhs = t(rng.standard_normal((B, N, dz + m, 1)))
    xk = kkt.condensed_solve(fk, C, Cn, rhs, dz)
    xp = kkt.condensed_solve_plain(fp, C, Cn, rhs, dz)
    err_s, rel = _rel_err(xk, xp)
    _check(rel < tol["K3"], f"condensed_solve ({dtype}) rel err {rel}")
    n_lev = Np.bit_length() - 1
    levels = sum(Np >> (k + 1) for k in range(n_lev)) + 1
    f_flops = B * (2 * N * m * dz * dz * 2 + N * m * m * dz * 2 * 3
                   + levels * (m ** 3 + 3 * m * m) + (Np - 1) * 5 * 2 * m ** 3)
    f_bytes = es * B * (N * dz * dz + N * m * dz + N * m + (N - 1) * m * dz
                        + 3 * Np * m * m)
    Xi = fk[0]
    record("condensed_factor", "piccolax_torch/csrc/condensed_cr.cu",
           "piccolax/solver/kkt.py:445", err_f,
           _time_ms(lambda: kkt.condense_cr_factor(Xi, C, R, Cn), reps),
           _time_ms(lambda: kkt.condense_cr_factor_plain(Xi, C, R, Cn), reps),
           bound(f_flops, f_bytes), None,
           f"{tol['K3']:.0e} relative; timed from the knot factors Xi (K1 excluded)",
           shape=f"B={B}, N={N}->{Np}, m={m}, dz={dz} {dtype}")
    s_flops = B * (N * 4 * dz * dz + N * 4 * m * dz * 2
                   + (Np - 1) * 6 * 2 * m * m + 2 * m * m)
    s_bytes = es * B * (N * dz * dz + N * m * dz + (N - 1) * m * dz
                        + 3 * Np * m * m + 2 * N * (dz + m))
    record("condensed_solve", "piccolax_torch/csrc/condensed_cr.cu",
           "piccolax/solver/kkt.py:464", err_s,
           _time_ms(lambda: kkt.condensed_solve(fk, C, Cn, rhs, dz), reps),
           _time_ms(lambda: kkt.condensed_solve_plain(fp, C, Cn, rhs, dz), reps),
           bound(s_flops, s_bytes), None, f"{tol['K3']:.0e} relative",
           shape=f"rhs [{B},{N},{dz + m},1] {dtype}")

    # -- K4: expm on the line-search residual sweep [B * cand * ls, N-1, 4, 4]
    # and on the derivative augmentations [B, N-1, nv^2, 12, 12]
    order = 12 if f64 else 8
    cand_ls, nv, sq = (3 * 8, 3, 1) if f64 else (2 * 6, 2, 0)
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
    Aaug = t(0.1 * rng.standard_normal((B, N - 1, nv * nv, 12, 12)))
    e12, rel12 = _rel_err(ex.expm_taylor_fixed(Aaug, order, sq + 1),
                          ex.expm_taylor_fixed_plain(Aaug, order, sq + 1))
    _check(rel12 < tol["K4"], f"expm_taylor_fixed 12x12 ({dtype}) rel err {rel12}")
    Mx = Aexp.numel() // 16
    record("expm_taylor_fixed", "piccolax_torch/csrc/expm_taylor.cu",
           "piccolax/ops/expm.py:143", max(err, e12),
           _time_ms(lambda: ex.expm_taylor_fixed(Aexp, order, sq), reps),
           _time_ms(lambda: ex.expm_taylor_fixed_plain(Aexp, order, sq), reps),
           bound(Mx * _taylor_flops(4, order, sq), 2 * Mx * 16 * es),
           _time_ms(lambda: torch.linalg.matrix_exp(Aexp), reps),
           f"{tol['K4']:.0e} relative (4 x 4 timed; 12 x 12 checked)",
           shape=f"[{B * cand_ls},{N - 1},4,4] {dtype}, order {order}, s={sq}")


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


def _read_launches(path, required):
    from piccolax_torch import _kernels
    launches = dict(_kernels.LAUNCHES)
    print(f"{path} launches: {json.dumps(launches)}", flush=True)
    for k in required:
        _check(launches[k] > 0, f"kernel {k} was not launched on the {path} path")
    return launches


def config1(B, N, T):
    """Phase 4: config 1 through the port's entry points, on the card."""
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
                         ls_iters=6, clamp_iters=15)
    pt.solve_nlp(nlp, params, Zb, device="cuda",        # warm-up, 2 iterations
                 options=pt.IPMOptions(**{**opts.__dict__, "max_iter": 2}))
    _kernels.reset_launch_counts()
    _sync()
    t0 = time.perf_counter()
    st = pt.solve_nlp(nlp, params, Zb, options=opts, device="cuda")
    _sync()
    seconds = time.perf_counter() - t0
    iters = int(st.it.max().item())
    launches = _read_launches("config-1", ["chol_inv_factor", "psd_clamp",
                                           "condensed_factor", "condensed_solve",
                                           "expm_taylor_fixed"])
    print(f"config 1: B={B} N={N} f32, {iters} iterations (max), "
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


def _quickstart_problem(device="cuda"):
    """docs/quickstart.py steps 1-4 (system, pulse, trajectory, problem)."""
    import piccolax_torch as pt
    sysq = pt.QuantumSystem(0.5 * pt.PAULIS["Z"], [pt.PAULIS["X"], pt.PAULIS["Y"]],
                            1.0)
    times = np.linspace(0.0, QS_T, QS_N)
    rng = np.random.default_rng(0)
    pulse = pt.ZeroOrderPulse(0.1 * rng.standard_normal((QS_N, 2)), times)
    qtraj = pt.UnitaryTrajectory(sysq, pulse, pt.GATES["X"], device=device)
    qcp = pt.SmoothPulseProblem(qtraj, QS_N, Q=100.0, R=1e-2, ddu_bound=1.0,
                                dt_bounds=(0.05, 0.2))
    return sysq, qtraj, qcp


ALL = ["chol_inv_factor", "psd_clamp", "condensed_factor", "condensed_solve",
       "expm_taylor_fixed", "expm_pade13"]


def quickstart():
    """Phase 5: the quickstart flow, steps 1-5, in float64 on the card."""
    import piccolax_torch as pt
    from piccolax_torch import _kernels

    _kernels.reset_launch_counts()
    _sync()
    t0 = time.perf_counter()
    sysq, qtraj, qcp = _quickstart_problem()
    F0 = float(qtraj.fidelity())
    qcp.solve(max_iter=150, tol=1e-7, verbose=True, device="cuda")
    F = float(qcp.fidelity())
    tt = qcp.traj.get_times()
    F_roll = float(pt.unitary_rollout_fidelity(
        sysq, qcp.traj["u"], tt, pt.GATES["X"], interpolation="constant",
        device="cuda"))
    _sync()
    wall = time.perf_counter() - t0
    launches = _read_launches("quickstart", ALL)
    iters = int(qcp.result.it)
    dF = abs(F - F_roll)
    print(f"quickstart: N={QS_N} T={QS_T} f64, initial F={F0:.6f}, {iters} "
          f"iterations, converged={qcp.converged}, stalled={qcp.stalled}, "
          f"wall {wall:.3f} s (construction, solve, sync, rollout check), "
          f"F={F:.9f}, F_roll={F_roll:.9f}, |dF|={dF:.3e}; per IPM iteration: "
          + json.dumps({k: round(v / iters, 2) for k, v in launches.items()}),
          flush=True)
    _check(F > 0.999, f"quickstart fidelity {F} <= 0.999")
    _check(dF < 1e-5, f"quickstart |F - F_roll| = {dF} >= 1e-5")
    return launches


def quickstart_batched(gate):
    """Phase 6: the quickstart problem at B = 256 (pulses perturbed by
    0.02 N(0, 1), as bench.py does) in one batched float64 solve with the
    Newton candidate, then one batched rollout (10 substeps) of all
    extracted pulses through one K5 launch."""
    import torch
    import piccolax_torch as pt
    from piccolax_torch import _kernels
    from piccolax_torch.quantum.dynamics import unitary_fidelity_iso

    sysq, _, qcp = _quickstart_problem()
    nlp, params, Z0, _, lay = qcp.build(device="cuda")
    u, dsl, Usl = lay.slices["u"], lay.slices["dt"], lay.slices["U"]
    rng = np.random.default_rng(0)
    Zb = np.broadcast_to(Z0.cpu().numpy()[None], (QS_B, *Z0.shape)).copy()
    Zb[:, :, u] += 0.02 * rng.standard_normal((QS_B, QS_N, u.stop - u.start))
    Zb = torch.as_tensor(Zb, device="cuda")
    opts = pt.IPMOptions(max_iter=150, tol=1e-7, constr_viol_tol=1e-7)
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
    launches = _read_launches("batched-quickstart", ALL)
    goal = params["goal"]["U"]
    F_rep = unitary_fidelity_iso(Z[:, -1, Usl], goal)
    F_roll, F_rep = F_roll.cpu().numpy(), F_rep.cpu().numpy()
    iters = int(st.it.max().item())
    n_conv = int(st.converged.sum().item())
    n_stall = int(st.stalled.sum().item())
    frac = float(np.mean(F_roll > 0.999))
    dF = np.abs(F_rep - F_roll)
    print(f"batched quickstart: B={QS_B} N={QS_N} f64, {iters} iterations (max), "
          f"solve {t_solve:.3f} s, {QS_B / t_solve:.2f} solves/s, with the "
          f"rollout {t_total:.3f} s; converged={n_conv}/{QS_B}, "
          f"stalled={n_stall}/{QS_B}, F_roll mean={F_roll.mean():.6f} "
          f"min={F_roll.min():.6f}, frac_F_roll>0.999={frac:.4f}, "
          f"mean|dF|={dF.mean():.2e}; per IPM iteration: "
          + json.dumps({k: round(v / iters, 2) for k, v in launches.items()}),
          flush=True)
    _check(bool(torch.isfinite(Z).all()) and np.all(np.isfinite(F_roll)),
           "batched quickstart: non-finite results")
    _check(frac >= gate, f"batched quickstart: frac_F_roll>0.999 {frac} < {gate}")
    return launches, (nlp, params, Zb, opts)


def profile(name, fn):
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
    print(f"profile {name}: wall {wall:.3f} s (profiled), device busy "
          f"{busy / 1e6:.3f} s, idle share {1 - busy / 1e6 / wall:.3f} of the "
          f"profiled run, {len(events)} device events", flush=True)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=20)
    print(table, flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile config 1 and both quickstart solves")
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
               tol, shape, extra=None):
        bound_ms, bound_by = bound
        lib = "none (no single PyTorch call)" if library_ms is None \
            else f"{library_ms:.4f}"
        print(f"{name} {shape}: max_err={err:.3e} ({tol}), kernel_ms={ms:.4f}, "
              f"plain_ms={plain_ms:.4f}, library_ms={lib}, "
              f"bound_ms={bound_ms:.4f} ({bound_by})", flush=True)
        row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms, "shape": shape}
        if name in rows:                       # the float64 quickstart shapes
            rows[name]["float64_quickstart"] = row
            return
        rows[name] = {"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": 0, **row, **(extra or {})}

    check_kernels(256, 50, 14, 12, "float32", record)
    check_kernels(QS_B, QS_N, 15, 13, "float64", record, reps=5)
    check_expm_pade13(record)

    paths = {}
    paths["config1"], run1 = config1(256, 50, 10.0)
    paths["quickstart"] = quickstart()
    paths["quickstart_b256"], run_b = quickstart_batched(gate=0.9)
    if args.profile:
        profile("config 1 solve (B=256, f32)",
                lambda: pt.solve_nlp(*run1[:3], options=run1[3], device="cuda"))
        _, _, qcp = _quickstart_problem()
        profile("quickstart solve (B=1, f64)",
                lambda: qcp.solve(max_iter=150, tol=1e-7, verbose=False,
                                  device="cuda"))
        profile("batched quickstart solve (B=256, f64)",
                lambda: pt.solve_nlp(*run_b[:3], options=run_b[3], device="cuda"))
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
