"""Milliseconds an IPM iteration of the three dg = 0 main paths (config 1,
the CNOT of config 3 and the qutrit X of config 2) in two trees of the
port, run in turns in fresh processes so that neither tree always runs
first.

    python3 scripts/ab_walls.py BASE_DIR CHANGE_DIR [--pairs 5] [--device cpu]
                                [--profile]

Pair i runs BASE then CHANGE when i is even and CHANGE then BASE when it is
odd (A B B A A B ...). Each turn is one process that imports
piccolax_torch from its tree, builds the three problems as chip_smoke.py's
phases 4, 10 and 14 do (same sizes, options and perturbed starts on the
card; tiny sizes with a fixed iteration count on the CPU), warms each up
with a 2-iteration solve and times one solve: ms an iteration is the
solve's seconds over its largest iteration count. On the card the kernels
are built once, in CHANGE_DIR, and copied to BASE_DIR when both trees hash
their kernel sources to the same build directory. Prints one JSON line a
turn ("AB ...") and, last, the per-cell medians and the per-pair ratios
CHANGE / BASE ("AB_SUMMARY ..."). --profile then runs config 1's timed
solve once more in each tree under torch.profiler and prints its operator
count, host and device time and the operators that take the most host
time ("AB_PROFILE ...").
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np


def _perturb(Z0, u_sl, B, scale, device):
    import torch
    rng = np.random.default_rng(0)
    Zb = np.broadcast_to(Z0.cpu().numpy().astype(np.float32)[None],
                         (B, *Z0.shape)).copy()
    Zb[:, :, u_sl] += scale * rng.standard_normal(
        (B, Z0.shape[0], u_sl.stop - u_sl.start)).astype(np.float32)
    return torch.as_tensor(Zb, device=device)


def _cells(pt, device):
    """name -> (problem factory, B, perturbation, IPMOptions kwargs)."""
    if device == "cuda":
        return {
            "c1": (lambda: pt.sx_gate_problem(N=50, T=10.0, device=device), 256, 0.02,
                   dict(max_iter=60, tol=5e-3, constr_viol_tol=5e-3, ls_iters=6,
                        clamp_iters=15)),
            "c3": (lambda: pt.cnot_problem(N=200, T=50.0, device=device), 16, 0.002,
                   dict(max_iter=150, tol=5e-3, constr_viol_tol=5e-3, hess_mode="abs",
                        delta_c_f32=1e-4, prox_iter=3)),
            "c2": (lambda: pt.qutrit_x_problem(N=100, T=20.0, device=device), 64, 0.005,
                   dict(max_iter=300, tol=5e-3, constr_viol_tol=5e-3, hess_mode="abs",
                        delta_c_f32=1e-4, prox_iter=3)),
        }
    tight = dict(tol=1e-14, constr_viol_tol=1e-14, acceptable_iter=10 ** 6)
    return {
        "c1": (lambda: pt.sx_gate_problem(N=11, T=4.0, device=device), 4, 0.02,
               dict(max_iter=8, ls_iters=6, clamp_iters=15, **tight)),
        "c3": (lambda: pt.cnot_problem(N=12, T=3.0, device=device), 2, 0.002,
               dict(max_iter=6, hess_mode="abs", delta_c_f32=1e-4, prox_iter=3,
                    **tight)),
        "c2": (lambda: pt.qutrit_x_problem(N=11, T=4.0, device=device), 2, 0.005,
               dict(max_iter=8, hess_mode="abs", delta_c_f32=1e-4, prox_iter=3,
                    **tight)),
    }


def _profiled(pt, torch, solve):
    """torch.profiler summary of one call of solve()."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        st = solve()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    avg = prof.key_averages()
    top = sorted(avg, key=lambda e: -e.self_cpu_time_total)[:15]
    return {"it_max": int(st.it.max().item()),
            "ops": int(sum(e.count for e in avg if e.key.startswith("aten::"))),
            "self_cpu_ms": round(sum(e.self_cpu_time_total for e in avg) / 1e3, 3),
            "device_ms": round(sum(getattr(e, "self_device_time_total", 0.0)
                                   for e in avg) / 1e3, 3),
            "top_self_cpu_ms": {e.key: [e.count, round(e.self_cpu_time_total / 1e3, 3)]
                                for e in top}}


def run_turn(tree, device, profile_c1=False):
    sys.path.insert(0, os.path.abspath(tree))
    import warnings
    import torch
    import piccolax_torch as pt
    if device == "cpu":
        torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    out = {"tree": tree}
    for name, (make, B, scale, kw) in _cells(pt, device).items():
        prob = make()
        nlp, params, Z0, _, layout = prob.build(device=device)
        Zb = _perturb(Z0, layout.slices["u"], B, scale, device)
        pt.solve_nlp(nlp, params, Zb, device=device,
                     options=pt.IPMOptions(**{**kw, "max_iter": 2}))
        if device == "cuda":
            torch.cuda.synchronize()
        if profile_c1:
            out["profile"] = _profiled(pt, torch, lambda: pt.solve_nlp(
                nlp, params, Zb, device=device, options=pt.IPMOptions(**kw)))
            print("AB_PROFILE " + json.dumps(out), flush=True)
            return
        t0 = time.perf_counter()
        st = pt.solve_nlp(nlp, params, Zb, device=device, options=pt.IPMOptions(**kw))
        if device == "cuda":
            torch.cuda.synchronize()
        s = time.perf_counter() - t0
        it = int(st.it.max().item())
        out[name] = {"s": round(s, 4), "it_max": it, "ms_per_it": round(1e3 * s / it, 3),
                     "conv": int(st.converged.sum().item())}
    print("AB " + json.dumps(out), flush=True)


def _share_build(src, dst):
    """Copy src's kernel build to dst when both hash to the same directory."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from piccolax_torch import _kernels; print(_kernels._build_dir())")
    dirs = [subprocess.run([sys.executable, "-c", code, os.path.abspath(t)],
                           capture_output=True, text=True, check=True).stdout.strip()
            for t in (src, dst)]
    if os.path.basename(dirs[0]) == os.path.basename(dirs[1]) and not os.path.exists(dirs[1]):
        shutil.copytree(dirs[0], dirs[1])
    print(f"builds: {dirs[0]} -> {dirs[1]}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("base")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--run", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.run:
        run_turn(a.run, a.device, a.profile)
        return
    if a.device == "cuda":
        code = ("import sys; sys.path.insert(0, sys.argv[1]); "
                "from piccolax_torch import _kernels; _kernels.build()")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", code, os.path.abspath(a.change)], check=True)
        print(f"kernel build {time.perf_counter() - t0:.1f} s", flush=True)
        _share_build(a.change, a.base)
    order = []
    for i in range(a.pairs):
        order += [a.base, a.change] if i % 2 == 0 else [a.change, a.base]
    res = {a.base: [], a.change: []}
    for tree in order:
        p = subprocess.run([sys.executable, os.path.abspath(__file__), a.base, a.change,
                            "--device", a.device, "--run", tree],
                           capture_output=True, text=True)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("AB ")]
        if p.returncode != 0 or not lines:
            sys.stderr.write(p.stdout + p.stderr)
            raise SystemExit(f"turn in {tree} failed ({p.returncode})")
        print(lines[-1], flush=True)
        res[tree].append(json.loads(lines[-1][len("AB "):]))
    summary = {}
    for cell in ("c1", "c3", "c2"):
        b = [r[cell]["ms_per_it"] for r in res[a.base]]
        c = [r[cell]["ms_per_it"] for r in res[a.change]]
        summary[cell] = {"base_median": float(np.median(b)),
                         "change_median": float(np.median(c)),
                         "pair_ratios": [round(y / x, 4) for x, y in zip(b, c)],
                         "same_iterations": all(
                             r[cell]["it_max"] == res[a.base][0][cell]["it_max"]
                             for r in res[a.base] + res[a.change])}
    print("AB_SUMMARY " + json.dumps(summary), flush=True)
    for tree in (a.base, a.change) if a.profile else ():
        p = subprocess.run([sys.executable, os.path.abspath(__file__), a.base, a.change,
                            "--device", a.device, "--profile", "--run", tree],
                           capture_output=True, text=True)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("AB_PROFILE ")]
        if p.returncode != 0 or not lines:
            sys.stderr.write(p.stdout + p.stderr)
            raise SystemExit(f"profile in {tree} failed ({p.returncode})")
        print(lines[-1], flush=True)


if __name__ == "__main__":
    main()
