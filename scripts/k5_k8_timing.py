#!/usr/bin/env python3
"""K5 (the rollout's Pade-13 expm, csrc/expm_pade13.cu) and K8 (the
lower-triangular inverse, csrc/tri_inv.cu) timed on the card.

Builds both sources twice with -Xptxas -v, one nvcc each, all side by
side: as the port builds them (timed), and with -DPX_K5_TIMING and
-DPX_K8_TIMING (clock64() stamps of block 0 and a last stamps argument of
px_expm_pade13 and px_tri_lower_inv; off in every other build). Prints:

- each kernel's registers and spills (ptxas -v), and its cuobjdump -sass
  counts (DFMA/FFMA, LDS, SHFL, BAR and the rest), over the whole function
  and over its hottest loop (the loop that holds the most multiply-adds);
- K5 at the rollouts of the paths (the quickstart's three at B = 1 and
  the batched quickstart's one, recorded from the calls of
  quantum/dynamics.py on the quickstart's initial pulses), at
  [253440, 2, 2] and at [3184, n, n] for n = 3, 4, 9 and 16, in complex128
  and complex64, each on two input sets: `anti_hermitian_by_squarings`
  (every squaring count 0-16 and the edges between them) and -iH h at the
  quickstart's rollout step (what the paths give: s = 0);
- K8 at [25600, m, m] for m = 16, 32, 44 and 64, float64 and float32, on
  Cholesky factors of SPD matrices;
- for each: the raw launch (CUDA events around 20 ctypes calls, the least
  of two runs, both printed), the wrapper's call (ops.expm.expm, solver.kkt.tri_lower_inv
  on the library just built), the plain version's time and a library
  call's (torch.linalg.matrix_exp, solve_triangular), the bound on the
  card (bytes and operations; K5's operations counted on 6 + s products
  and the solve, the old count of 23 + s products in brackets), the error
  against the plain version, and the stamps of one launch: K5's cycles of
  block 0's first matrix to load it and take its norm, form the powers, U
  and V, solve for F, square and store; K8's cycles to load, substitute
  and store, and the most and fewest cycles a lane of the first warp
  spent substituting.

Run from the root of a checkout on a machine with the card:

    python3 scripts/k5_k8_timing.py
    mkdir -p .chipcheck/pr10 && git archive dd74b40 piccolax_torch/csrc | tar -x -C .chipcheck/pr10
    python3 scripts/k5_k8_timing.py --baseline .chipcheck/pr10/piccolax_torch/csrc

--baseline DIR also builds commit dd74b40's expm_pade13.cu and tri_inv.cu
from DIR (the Newton-Schulz K5, one warp a block K8), their stamps added
by scripts/k5_k8_timing/pr10_stamps.patch, and times both builds at every
shape in one process, in turns (baseline, current, current, baseline).
--variant DIR (repeatable) adds another tree's csrc whose sources carry
the stamps switches already (an earlier design of the current kernels),
timed in the same turns (baseline, variants, current, then back).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from chip_smoke import _bound, _lower_tri_bytes, _pade13_flops  # noqa: E402
from cr_phase_timing import apply_patch, card_line, nvcc, ptxas_summary, split_patch  # noqa: E402
from expm_timing import sass_counts  # noqa: E402

CSRC = ROOT / "piccolax_torch" / "csrc"
PATCH = ROOT / "scripts" / "k5_k8_timing" / "pr10_stamps.patch"
SOURCES = ("expm_pade13", "tri_inv")
QS_N, QS_T, QS_B = 100, 10.0, 256
K5_BATCH = 3184                 # 16 x 199, the 4 x 4 rollouts of chip_smoke.py
K8_BATCH = 25600
K5_STAMPS = ("load and norm", "powers", "U and V", "solve", "squarings", "store")
K8_STAMPS = ("load", "substitution", "store")
SASS_OPS = ("DFMA", "FFMA", "LDS", "SHFL", "BAR", "WARPSYNC")


def build(src_dir: Path, name: str, out_dir: Path, timed: bool):
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"{name}{'_timed' if timed else ''}.so"
    cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(src_dir), "-o",
           str(so), str(src_dir / f"{name}.cu")]
    if timed:
        cmd[1:1] = ["-DPX_K5_TIMING", "-DPX_K8_TIMING"]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)


class Build:
    """Both libraries of one source tree, as shipped and with stamps."""

    def __init__(self, label, src_dir, timed_dir, out_dir):
        self.label = label
        self.jobs = {(name, timed): build(timed_dir if timed else src_dir, name, out_dir,
                                          timed)
                     for name in SOURCES for timed in (False, True)}

    def finish(self):
        self.logs, self.libs = {}, {}
        I_, P_, L_ = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
        sig = {"expm_pade13": ("px_expm_pade13", [I_, P_, P_, P_, L_, I_, I_, P_]),
               "tri_inv": ("px_tri_lower_inv", [I_, P_, P_, L_, I_, P_])}
        for (name, timed), (so, p) in self.jobs.items():
            log, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed for {so}:\n{log}")
            lib = ctypes.CDLL(str(so))
            fn, args = sig[name]
            f = getattr(lib, fn)
            f.argtypes = args + ([P_] if timed else [])
            f.restype = I_
            self.libs[(name, timed)] = lib
            if not timed:
                self.logs[name] = (so, log)

    def report_build(self):
        print(f"== {self.label}", flush=True)
        for name, (so, log) in self.logs.items():
            for kern, regs, spill, frame in ptxas_summary(log):
                print(f"  ptxas {kern}: {regs} registers, {spill} bytes spilled, "
                      f"{frame} bytes stack frame", flush=True)
            for fn, whole, loop_len, loop in sass_counts(so):
                w = ", ".join(f"{op} {whole[op]}" for op in SASS_OPS if whole.get(op))
                lp = ", ".join(f"{op} {loop[op]}" for op in SASS_OPS if loop.get(op))
                print(f"  sass {fn}: {whole['all']} instructions ({w}); hottest loop "
                      f"{loop_len} ({lp or 'none'})", flush=True)

    def use(self):
        """Point the port's wrappers at this build's libraries."""
        from piccolax_torch import _kernels
        _kernels._LIBS["expm_pade13"] = self.libs[("expm_pade13", False)]
        _kernels._LIBS["tri_inv"] = self.libs[("tri_inv", False)]


def least_ms(fn, reps=20, runs=2):
    import torch
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b) / reps)
    return best


def in_turns(builds, make_fn, reps=20):
    """Each build's fn timed in turns (b0, b1, b1, b0): its two ms."""
    order = builds + builds[::-1]
    ms = {b.label: [] for b in builds}
    for b in order:
        ms[b.label].append(least_ms(make_fn(b), reps, runs=1))
    return ms


def turns(ms):
    """The least of a build's turns, the other beside it."""
    return f"{min(ms):.4f} ms (turns {' / '.join(f'{t:.4f}' for t in ms)})"


def stream():
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


# ---- K5 --------------------------------------------------------------------

def k5_bound(A, s):
    """chip_smoke.py's bound on the kernel's body, the bound on 23 + s
    products (the Newton-Schulz kernel's) in brackets."""
    n = A.shape[-1]
    real = "float64" if A.element_size() == 16 else "float32"
    nbytes = 2 * A.numel() * A.element_size()
    new = _bound(_pade13_flops(n, s), nbytes, real)
    old = _bound(_pade13_flops(n, s, newton_schulz=True), nbytes, real)
    return f"{new[0]:.4f} ({new[1]}) [{old[0]:.4f} ({old[1]}) on 23 + s products]"


def path_rollouts():
    """The A [..., 2, 2] of every K5 call of the quickstart (construction,
    re-sync, rollout check; B = 1) and of the batched quickstart's rollout
    (B = 256, pulses perturbed by 0.02 N(0, 1)), on the initial pulses, as
    quantum/dynamics.py passes them to expm."""
    import torch
    import piccolax_torch as pt
    from piccolax_torch.quantum import dynamics
    seen = []
    real = dynamics.expm

    def rec(A, *a, **k):
        seen.append(A.clone())
        return real(A, *a, **k)

    dynamics.expm = rec
    try:
        sysq = pt.QuantumSystem(0.5 * pt.PAULIS["Z"], [pt.PAULIS["X"], pt.PAULIS["Y"]], 1.0)
        times = np.linspace(0.0, QS_T, QS_N)
        rng = np.random.default_rng(0)
        u = 0.1 * rng.standard_normal((QS_N, 2))
        pulse = pt.ZeroOrderPulse(u, times)
        qtraj = pt.UnitaryTrajectory(sysq, pulse, pt.GATES["X"], device="cuda")
        qtraj.rollout(pulse)
        pt.unitary_rollout_fidelity(sysq, torch.as_tensor(u, device="cuda"), times,
                                    pt.GATES["X"], interpolation="constant")
        ub = u[None] + 0.02 * rng.standard_normal((QS_B, QS_N, 2))
        pt.unitary_rollout_fidelity(sysq, torch.as_tensor(ub, device="cuda"),
                                    np.broadcast_to(times, (QS_B, QS_N)).copy(),
                                    pt.GATES["X"], interpolation="constant")
    finally:
        dynamics.expm = real
    names = ["qs construction", "qs re-sync", "qs rollout check", "qs256 rollout"]
    return list(zip(names, seen))


def step_inputs(M, n, cdt, rng):
    """-iH h: H Hermitian N(0, 1) scaled to the quickstart Hamiltonian's
    inf-norm (0.5 |Z| + |u| ~ 0.64), h its rollout check's step (dt / 10)."""
    G = rng.standard_normal((M, n, n)) + 1j * rng.standard_normal((M, n, n))
    H = G + np.conj(np.swapaxes(G, -1, -2))
    H *= (0.64 / np.abs(H).sum(-1).max(-1))[:, None, None]
    h = QS_T / (QS_N - 1) / 10
    return np.ascontiguousarray(-1j * h * H, dtype=cdt)


def k5_cases():
    from piccolax_torch.ops import expm as ex
    import torch
    rng = np.random.default_rng(5)
    cases = [(name, A.contiguous()) for name, A in path_rollouts()]
    for n, M in ((2, QS_B * (QS_N - 1) * 10), *((n, K5_BATCH) for n in (3, 4, 9, 16))):
        for cdt in (np.complex128, np.complex64):
            tag = f"[{M},{n},{n}] {np.dtype(cdt).name}"
            cases.append((f"{tag} by squarings", torch.as_tensor(
                ex.anti_hermitian_by_squarings(M, n, rng, cdt), device="cuda")))
            cases.append((f"{tag} -iHh", torch.as_tensor(step_inputs(M, n, cdt, rng),
                                                         device="cuda")))
    return cases


def run_k5(builds, reps):
    import torch
    from piccolax_torch.ops import expm as ex
    builds[-1].use()                   # the paths' rollouts run on it
    for label, A in k5_cases():
        n = A.shape[-1]
        batch = A.numel() // (n * n)
        c128 = A.dtype == torch.complex128
        tol = 1e-12 if c128 else 1e-4
        ref = ex.expm_plain(A)
        s_ref = ex.pade13_squarings(A)
        out = torch.empty_like(A)
        s = torch.empty(A.shape[:-2], dtype=torch.int32, device="cuda")
        errs, stamps = {}, {}
        for b in builds:
            lib = b.libs[("expm_pade13", False)]
            rc = lib.px_expm_pade13(int(c128), torch.view_as_real(A).data_ptr(),
                                    torch.view_as_real(out).data_ptr(), s.data_ptr(), batch,
                                    n, 16, stream())
            torch.cuda.synchronize()
            if rc or not torch.equal(s, s_ref):
                raise RuntimeError(f"K5 {label} {b.label}: rc {rc} or squaring counts differ")
            rel = ((out - ref).abs().amax(dim=(-2, -1)) / ref.abs().amax(dim=(-2, -1)))
            lim = tol * torch.pow(2.0, torch.clamp(s_ref - 6, min=0).double())
            if not bool((rel <= lim).all()):
                raise RuntimeError(f"K5 {label} {b.label}: rel err {rel.max().item():.3e}")
            errs[b.label] = rel.max().item()
            st = torch.full((16,), -1, dtype=torch.int64, device="cuda")
            tl = b.libs[("expm_pade13", True)]
            rc = tl.px_expm_pade13(int(c128), torch.view_as_real(A).data_ptr(),
                                   torch.view_as_real(out).data_ptr(), None, batch, n, 16,
                                   stream(), ctypes.c_void_p(st.data_ptr()))
            torch.cuda.synchronize()
            if rc:
                raise RuntimeError(f"K5 {label} {b.label} (stamps): rc {rc}")
            stamps[b.label] = st.cpu().tolist()

        def raw(b):
            lib = b.libs[("expm_pade13", False)]
            a_p, o_p = torch.view_as_real(A).data_ptr(), torch.view_as_real(out).data_ptr()
            st = stream()
            return lambda: lib.px_expm_pade13(int(c128), a_p, o_p, None, batch, n, 16, st)

        def wrapper(b):
            b.use()
            return lambda: ex.expm(A)

        raw_ms = in_turns(builds, raw, reps)
        wr_ms = in_turns(builds, wrapper, reps)
        plain = least_ms(lambda: ex.expm_plain(A), 5)
        library = least_ms(lambda: torch.linalg.matrix_exp(A), 5)
        hist = torch.bincount(s_ref.flatten().long(), minlength=17).tolist()
        s_note = f"s mean {s_ref.double().mean().item():.2f}, " + \
            ("s = 0 only" if hist[0] == batch else f"counts by s {hist}")
        print(f"K5 {label} [{batch},{n},{n}]: plain {plain:.4f} ms, matrix_exp "
              f"{library:.4f} ms, bound {k5_bound(A, s_ref)}; {s_note}", flush=True)
        for b in builds:
            st = stamps[b.label]
            cyc = ", ".join(f"{K5_STAMPS[i]} {st[i + 1] - st[i]}" for i in range(6))
            print(f"  {b.label}: raw launch {turns(raw_ms[b.label])}, wrapper "
                  f"{turns(wr_ms[b.label])}, max rel err {errs[b.label]:.2e}; first matrix "
                  f"(s = {st[9]}) cycles: {cyc}; block 0's span "
                  f"{(st[8] - st[7]) / 1e3:.1f} us", flush=True)


# ---- K8 --------------------------------------------------------------------

def run_k8(builds, reps):
    import torch
    from piccolax_torch.solver import kkt
    rng = np.random.default_rng(31)
    for m in (16, 32, 44, 64):
        X = rng.standard_normal((K8_BATCH, m, m))
        L0 = np.linalg.cholesky(X @ np.swapaxes(X, -1, -2) / m + np.eye(m))
        for real in ("float64", "float32"):
            L = torch.as_tensor(L0, dtype=getattr(torch, real), device="cuda")
            f64 = int(real == "float64")
            es = 8 if f64 else 4
            out = torch.empty_like(L)
            ref = kkt.tri_lower_inv_plain(L)
            errs, stamps = {}, {}
            for b in builds:
                rc = b.libs[("tri_inv", False)].px_tri_lower_inv(
                    f64, L.data_ptr(), out.data_ptr(), K8_BATCH, m, stream())
                torch.cuda.synchronize()
                rel = ((out.double() - ref.double()).abs().max()
                       / ref.double().abs().max()).item()
                if rc or not rel < (1e-12 if f64 else 1e-5):
                    raise RuntimeError(f"K8 {m} {real} {b.label}: rc {rc}, rel err {rel:.3e}")
                errs[b.label] = rel
                st = torch.full((8,), -1, dtype=torch.int64, device="cuda")
                rc = b.libs[("tri_inv", True)].px_tri_lower_inv(
                    f64, L.data_ptr(), out.data_ptr(), K8_BATCH, m, stream(),
                    ctypes.c_void_p(st.data_ptr()))
                torch.cuda.synchronize()
                if rc:
                    raise RuntimeError(f"K8 {m} {real} {b.label} (stamps): rc {rc}")
                stamps[b.label] = st.cpu().tolist()

            def raw(b):
                lib = b.libs[("tri_inv", False)]
                lp, op, st = L.data_ptr(), out.data_ptr(), stream()
                return lambda: lib.px_tri_lower_inv(f64, lp, op, K8_BATCH, m, st)

            def wrapper(b):
                b.use()
                return lambda: kkt.tri_lower_inv(L)

            raw_ms = in_turns(builds, raw, reps)
            wr_ms = in_turns(builds, wrapper, reps)
            eye = torch.eye(m, dtype=L.dtype, device="cuda").expand_as(L)
            plain = least_ms(lambda: kkt.tri_lower_inv_plain(L), 5)
            library = least_ms(lambda: torch.linalg.solve_triangular(L, eye, upper=False), 5)
            b_ms, b_by = _bound(K8_BATCH * m * (m + 1) * (2 * m + 1) // 6,
                                K8_BATCH * (_lower_tri_bytes(m, es) + m * m * es), real)
            print(f"K8 [{K8_BATCH},{m},{m}] {real}: plain {plain:.4f} ms, solve_triangular "
                  f"{library:.4f} ms, bound {b_ms:.4f} ({b_by})", flush=True)
            for b in builds:
                st = stamps[b.label]
                cyc = ", ".join(f"{K8_STAMPS[i]} {st[i + 1] - st[i]}" for i in range(3))
                print(f"  {b.label}: raw launch {turns(raw_ms[b.label])}, wrapper "
                      f"{turns(wr_ms[b.label])}, rel err {errs[b.label]:.2e}; block 0's "
                      f"first warp cycles: {cyc}; lanes substituting: most {st[6]}, "
                      f"fewest {st[7]}; block 0's span {(st[5] - st[4]) / 1e3:.1f} us",
                      flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path,
                    help="commit dd74b40's piccolax_torch/csrc, timed beside the current "
                         "sources, its stamps from scripts/k5_k8_timing/pr10_stamps.patch")
    ap.add_argument("--variant", type=Path, action="append", default=[],
                    help="another csrc with the stamps switches (an earlier design), "
                         "timed in turns beside the others")
    ap.add_argument("--only-baseline", action="store_true", help="time the baseline alone")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k5_k8_timing: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    out = ROOT / "piccolax_torch" / "_build" / "k5_k8_timing"
    t0 = time.perf_counter()           # every build side by side
    builds = []
    if args.baseline:
        tdir = out / "baseline_timed_src"
        tdir.mkdir(parents=True, exist_ok=True)
        patches = split_patch(PATCH.read_text())
        for f in args.baseline.iterdir():
            if f.suffix in (".cu", ".cuh"):
                text = f.read_text()
                if f.name in patches:
                    text = apply_patch(text, patches[f.name])
                (tdir / f.name).write_text(text)
        builds.append(Build("baseline dd74b40", args.baseline, tdir, out / "baseline"))
    for i, v in enumerate(args.variant):
        builds.append(Build(f"variant {v}", v, v, out / f"variant{i}"))
    if not args.only_baseline:
        builds.append(Build("current", CSRC, CSRC, out / "current"))
    for b in builds:
        b.finish()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    for b in builds:
        b.report_build()
    run_k5(builds, args.reps)
    run_k8(builds, args.reps)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
