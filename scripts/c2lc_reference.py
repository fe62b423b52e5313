#!/usr/bin/env python3
"""piccolax's own result for the leakage-constrained qutrit X batch (the
"c2lc" path of chip_smoke.py, phase 17), on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 scripts/c2lc_reference.py [--B 64]

Builds `piccolax.benchmarks.qutrit_x_problem(N=100, T=20,
leakage_value=1e-3)` (the leakage cost of config 2 plus a
`LeakageConstraint`: dz = 25, md = 22, me = 1, a slack a knot), casts it
to float32, perturbs the pulse columns of Z0 by 0.005 N(0, 1) (seed 0,
the draws of chip_smoke's `_perturbed_start`) and solves the batch with
jit(vmap(solve_nlp)) under config 2's options (bench.py:191-194). Prints
the converged count, the iterations, the largest knot leakage of the
converged problems and their float64 DOP853 subspace fidelities. Then
(alone with --f64-only) the unperturbed Z0 in float64 for 30 iterations
under the same options: it, kkt_err, mu, the objective and sums of Z and
lam, which chip_smoke holds the port's float64 run on the card against.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--B", type=int, default=64)
    ap.add_argument("--f64-only", action="store_true")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import jax.tree_util as jtu

    from piccolax import benchmarks as bm
    from piccolax.quantum.gates import GATES
    from piccolax.quantum.operators import annihilate, get_iso_vec_leakage_indices
    from piccolax.solver.ipm import IPMOptions, solve_nlp
    from piccolax.verification import batched_unitary_dop853, pedersen_fidelity_np

    N, T, B = 100, 20.0, args.B
    prob = bm.qutrit_x_problem(N=N, T=T, leakage_value=1e-3)
    nlp, params, Z0, g0, layout = prob.build()
    print(f"dz={nlp.dz} dg={nlp.dg} md={nlp.md} me={nlp.me}", flush=True)

    def cast32(tree):
        return jtu.tree_map(lambda x: x.astype(jnp.float32) if hasattr(x, "dtype")
                            and x.dtype == jnp.float64 else x, tree)

    opts = dict(tol=5e-3, constr_viol_tol=5e-3, hess_mode="abs", delta_c_f32=1e-4,
                prox_iter=3)
    st = jax.jit(lambda Z, g: solve_nlp(nlp, params, Z, g, IPMOptions(max_iter=30, **opts)))(
        Z0, g0)
    print(json.dumps({"float64_30": {
        "it": int(st.it), "kkt_err": float(st.kkt_err), "mu": float(st.mu),
        "f": float(st.f_prev), "sum_Z": float(jnp.sum(st.Z)),
        "sum_Z2": float(jnp.sum(st.Z ** 2)), "sum_lam": float(jnp.sum(st.lam))}}), flush=True)
    if args.f64_only:
        return
    nlp, params = cast32(nlp), cast32(params)
    u_sl = layout.slices["u"]
    rng = np.random.default_rng(0)
    Zb = np.broadcast_to(np.asarray(Z0, np.float32)[None], (B, N, nlp.dz)).copy()
    Zb[:, :, u_sl] += 0.005 * rng.standard_normal(
        (B, N, u_sl.stop - u_sl.start)).astype(np.float32)
    o32 = IPMOptions(max_iter=300, **opts)
    fn = jax.jit(jax.vmap(lambda Z, g: solve_nlp(nlp, params, Z, g, o32)))
    t0 = time.perf_counter()
    st = fn(jnp.asarray(Zb), jnp.zeros((B, 0), jnp.float32))
    Z = np.asarray(st.Z, np.float64)
    seconds = time.perf_counter() - t0
    its = np.asarray(st.it)
    conv = np.asarray(st.converged)
    leak_idx = get_iso_vec_leakage_indices([0, 1], 3)
    pops = np.sum(Z[:, :, layout.slices["U"]][..., leak_idx] ** 2, axis=-1)
    # the transmon's Hamiltonians in numpy float64, as bench.py's config 2
    a = annihilate(3)
    ad = a.conj().T
    H0 = 2 * np.pi * (-0.2 / 2) * (ad @ ad @ a @ a)
    Hds = [2 * np.pi * (a + ad), 2 * np.pi * 1j * (a - ad)]
    U64 = batched_unitary_dop853(H0, Hds, Z[:, :, u_sl], np.linspace(0, T, N))
    Fs = pedersen_fidelity_np(U64[:, :2, :2], np.asarray(GATES["X"]))
    out = {"B": B, "converged": int(conv.sum()), "it_max": int(its.max()),
           "it_mean": float(its.mean()), "it_min": int(its.min()),
           "n_max_iter": int((its >= 300).sum()),
           "max_knot_leakage_converged": float(pops[conv].max()) if conv.any() else None,
           "min_F_converged": float(Fs[conv].min()) if conv.any() else None,
           "mean_F": float(Fs.mean()), "min_F": float(Fs.min()),
           "seconds_with_compile": seconds, "converged_flags": conv.astype(int).tolist(),
           "iterations": its.tolist()}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
