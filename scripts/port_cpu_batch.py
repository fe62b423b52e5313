#!/usr/bin/env python3
"""The port's own float32 results for chip_smoke's phase-16 and phase-17
batches on the CPU (the kernels' plain versions), from the starts those
phases take: c2lc, qutrit_x_problem(N=100, T=20, leakage_value=1e-3) at
B = 64 with config 2's options (scripts/c2lc_reference.py prints
piccolax's flags beside these); c3fp, cnot_problem(N=200, T=50,
free_phase=True) at a B of its own with config 3's options, and each
problem's phases and float64 DOP853 fidelity against Z(theta) CX. Prints
the converged count, the iterations and the per-problem flags.

    python3 scripts/port_cpu_batch.py c2lc [--B 64] [--threads 3]
    python3 scripts/port_cpu_batch.py c3fp --B 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", choices=("c2lc", "c3fp"))
    ap.add_argument("--B", type=int, default=64)
    ap.add_argument("--threads", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath("."))
    import torch
    torch.set_num_threads(args.threads)
    import piccolax_torch as pt

    B = args.B
    if args.path == "c2lc":
        prob = pt.qutrit_x_problem(N=100, T=20.0, leakage_value=1e-3, device="cpu")
        opts = pt.IPMOptions(max_iter=300, tol=5e-3, constr_viol_tol=5e-3,
                             hess_mode="abs", delta_c_f32=1e-4, prox_iter=3)
        scale = 0.005
    else:
        prob = pt.cnot_problem(N=200, T=50.0, free_phase=True, device="cpu")
        opts = pt.IPMOptions(max_iter=150, tol=5e-3, constr_viol_tol=5e-3,
                             hess_mode="abs", delta_c_f32=1e-4, prox_iter=3)
        scale = 0.002
    nlp, params, Z0, g0, layout = prob.build(device="cpu")
    N, u = Z0.shape[0], layout.slices["u"]
    rng = np.random.default_rng(0)
    Zb = np.broadcast_to(Z0.numpy().astype(np.float32)[None], (B, *Z0.shape)).copy()
    Zb[:, :, u] += scale * rng.standard_normal((B, N, u.stop - u.start)).astype(np.float32)
    t0 = time.perf_counter()
    st = pt.solve_nlp(nlp, params, torch.as_tensor(Zb), g0.float(), options=opts,
                      device="cpu")
    its, conv = st.it.numpy(), st.converged.numpy()
    out = {"path": args.path, "B": B, "converged": int(conv.sum()),
           "it_max": int(its.max()), "it_mean": float(its.mean()),
           "n_max_iter": int((its >= opts.max_iter).sum()),
           "seconds": time.perf_counter() - t0,
           "converged_flags": conv.astype(int).tolist(), "iterations": its.tolist()}
    if args.path == "c3fp":
        from piccolax_torch.quantum.dynamics import free_phase_diagonal
        from piccolax_torch.verification import batched_unitary_dop853, unitary_fidelity_np
        theta = st.g.double().numpy()
        sysq = prob.qtraj.system
        U = batched_unitary_dop853(sysq.H_drift, np.stack(sysq.H_drives),
                                   st.Z.double().numpy()[:, :, u], np.linspace(0, 50.0, N))
        d = free_phase_diagonal(torch.as_tensor(theta), 2, 4).numpy()
        out.update(theta=theta.tolist(),
                   F_phased=unitary_fidelity_np(U, d[:, :, None] * prob.qtraj.goal).tolist(),
                   F_cx=unitary_fidelity_np(U, prob.qtraj.goal).tolist())
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
