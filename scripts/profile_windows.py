#!/usr/bin/env python3
"""Device time an IPM iteration of five solve paths, profiled over
20-iteration windows: config 3 (B = 16, float32, "cr"), the CNOT (B = 1,
float64, "cr" and "knot" with P = 8 partitions), the batched quickstart
(B = 256, float64, Taylor, "cr") and the batched Pade/qd quickstart
(B = 256, float64, Pade 7, "qd").

Run from the root of a checkout on a machine with the card; it uses that
checkout's chip_smoke.py and piccolax_torch, so it also profiles an
earlier tree unpacked elsewhere:

    python3 scripts/profile_windows.py
    mkdir -p .chipcheck/parent && git archive 7f95e32 | tar -x -C .chipcheck/parent
    (cd .chipcheck/parent && python3 ../../scripts/profile_windows.py)

Each window follows a 2-iteration warm-up. For each it prints the kernel
launches of the window (K4 and K6 by block width), then chip_smoke's
profile line (wall, device busy time, idle share, device time an
iteration) and the kernels by device time.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.getcwd())


def main():
    import torch
    if not torch.cuda.is_available():
        print("profile_windows: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import piccolax_torch as pt
    from piccolax_torch import _kernels

    card = cs._card()
    print(card, flush=True)
    _kernels.build()
    rng = np.random.default_rng(0)
    windows = []

    prob = pt.cnot_problem(N=cs.C3_N, T=cs.C3_T, device="cuda")
    nlp, params, Z0, _, layout = prob.build(device="cuda")
    u_sl = layout.slices["u"]
    Zb = np.broadcast_to(Z0.cpu().numpy().astype(np.float32)[None],
                         (cs.C3_B, cs.C3_N, layout.z_dim)).copy()
    Zb[:, :, u_sl] += 0.002 * rng.standard_normal(
        (cs.C3_B, cs.C3_N, u_sl.stop - u_sl.start)).astype(np.float32)
    windows.append(("config 3 (B=16, f32, cr)", nlp, params,
                    torch.as_tensor(Zb, device="cuda"), cs._c3_options()))
    windows.append(("CNOT (B=1, f64, cr)", nlp, params, Z0,
                    pt.IPMOptions(max_iter=20, kkt_backend="cr")))
    windows.append(("CNOT (B=1, f64, knot, P=8)", nlp, params, Z0,
                    pt.IPMOptions(max_iter=20, kkt_backend="knot")))
    for order, backend, label in (("taylor", "cr", "batched quickstart (B=256, f64, cr)"),
                                  (7, "qd", "batched Pade/qd quickstart (B=256, f64, qd)")):
        _, _, qcp = cs._quickstart_problem(pade_order=order)
        nlpq, paramsq, Z0q, _, lay = qcp.build(device="cuda")
        u = lay.slices["u"]
        Zq = np.broadcast_to(Z0q.cpu().numpy()[None], (cs.QS_B, *Z0q.shape)).copy()
        Zq[:, :, u] += 0.02 * rng.standard_normal((cs.QS_B, cs.QS_N, u.stop - u.start))
        windows.append((label, nlpq, paramsq, torch.as_tensor(Zq, device="cuda"),
                        cs._qs_options(backend)))

    for label, nlp_, params_, Z_, opts in windows:
        mesh = max(cs.KNOT_PARTS) if opts.kkt_backend == "knot" else None

        def run(n):
            return pt.solve_nlp(nlp_, params_, Z_, device="cuda", mesh=mesh,
                                options=pt.IPMOptions(**{**opts.__dict__, "max_iter": n}))
        run(2)
        _kernels.reset_launch_counts()
        cs._sync()
        run(20)
        cs._sync()
        print(f"{label} launches in 20 iterations: {json.dumps(_kernels.LAUNCHES)}; "
              f"K4 and K6 by block width: {json.dumps(_kernels.WIDTHS)}", flush=True)
        cs.profile(f"{label}, 20 iterations", lambda: run(20), 20)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
