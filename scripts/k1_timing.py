#!/usr/bin/env python3
"""K1 (chol_inv_factor, csrc/chol_inv.cu) timed on the card.

Builds csrc/chol_inv.cu twice with -Xptxas -v, one nvcc each, side by
side: as the port builds it (timed), and with -DPX_K1_TIMING (the
clock64() stamps of the first block of the launch and a last stamps
argument of px_chol_inv_factor; off in every other build). Prints:

- each kernel's registers and spills (one kernel a width class: 16, 32,
  48 and 64 wide), from ptxas -v;
- the cuobjdump -sass counts of each width class's kernel (SHFL, LDS,
  STS, FFMA/DFMA, BAR and the rest), whole and a pivot on average;
- at the six shapes of the solve paths (config 1, the quickstart at B = 1
  and 256, config 3, the CNOT on "cr" and on "knot", which share one
  shape), the time of a raw launch (CUDA events around 20 ctypes calls,
  the least of two runs), beside the time of a call of the wrapper
  kkt.chol_inv_factor, which chip_smoke.py times, of the plain version and
  of torch.linalg.cholesky_ex with solve_triangular (a yardstick), and the
  plain version's relative error and NaN mask;
- the stamps of one launch at each shape: cycles of the first block's
  first warp to stage its blocks (load), equilibrate, run the pivots, write
  Xi to shared memory and store it, and the launch's ns from that block's
  start to its end (%globaltimer).

Run from the root of a checkout on a machine with the card:

    python3 scripts/k1_timing.py
    mkdir -p .chipcheck/pr9 && git archive 9e52288 piccolax_torch/csrc | tar -x -C .chipcheck/pr9
    python3 scripts/k1_timing.py --baseline .chipcheck/pr9/piccolax_torch/csrc

--baseline DIR also times, first and in the same process, commit
9e52288's chol_inv.cu (one warp a block up to 32 wide, two past it) from
DIR, its stamps added by scripts/k1_timing/pr9_k1_stamps.patch.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from cr_phase_timing import apply_patch, card_line, nvcc, ptxas_summary, split_patch  # noqa: E402

CSRC = ROOT / "piccolax_torch" / "csrc"
PATCH = ROOT / "scripts" / "k1_timing" / "pr9_k1_stamps.patch"
# (path, batch of blocks, width, dtype, launches on the path)
SHAPES = [("c1 [256,50,14,14]", 256 * 50, 14, "float32", 31),
          ("qs [1,100,15,15]", 100, 15, "float64", 264),
          ("qs256 [256,100,15,15]", 256 * 100, 15, "float64", 300),
          ("c3 [16,200,44,44]", 16 * 200, 44, "float32", 44),
          ("CNOT cr / ck8 [1,200,44,44]", 200, 44, "float64", 72 + 72)]
STAMP_NAMES = ("load", "equilibrate", "pivots", "Xi to smem", "store")
OPS = ("SHFL", "LDS", "STS", "FFMA", "DFMA", "FMUL", "DMUL", "BAR", "SEL", "FSEL")


def build(src_dir: Path, out_dir: Path, timed: bool):
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / ("chol_inv_timed.so" if timed else "chol_inv.so")
    cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(src_dir), "-o",
           str(so), str(src_dir / "chol_inv.cu")]
    if timed:
        cmd.insert(1, "-DPX_K1_TIMING")
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)


def sass_functions(so: Path) -> dict[str, dict[str, int]]:
    """Opcode counts of every function of `so` (cuobjdump -sass)."""
    tool = subprocess.run(["which", "cuobjdump"], capture_output=True, text=True).stdout.strip()
    text = subprocess.run([tool or "/usr/local/cuda/bin/cuobjdump", "-sass", str(so)],
                          capture_output=True, text=True).stdout
    out = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name = block.splitlines()[0].strip()
        hist = {}
        for line in block.splitlines():
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
            if m:
                hist[m.group(1)] = hist.get(m.group(1), 0) + 1
        out[name] = hist
    return out


def chain_pivots(W: int) -> int:
    """Pivots of every Cholesky routine a class-W kernel of 9e52288 holds:
    one per pivot count chol_width(n) for n up to W (4, 8, ..., 32, then
    40, ...); the current kernel holds one routine of W pivots."""
    counts = sorted({(n + 3) // 4 * 4 if n <= 32 else (n + 7) // 8 * 8 for n in range(1, W + 1)})
    return sum(counts)


def report_sass(so: Path, chain: bool):
    """Opcode counts of each width class's kernel (cuobjdump shows the
    Cholesky routines inside their kernel), whole and a pivot: over the
    pivots of the routines the kernel holds (chain: 9e52288's, one routine
    a pivot count, chain_pivots; else one of W), so a pivot on average."""
    for name, hist in sorted(sass_functions(so).items()):
        m = re.search(r"chol_inv_factor_kernelI([df])Li(\d+)E", name)
        if not m:
            continue
        W = int(m.group(2))
        piv = chain_pivots(W) if chain else W
        per = ", ".join(f"{op} {hist.get(op, 0) / piv:.1f}" for op in OPS if hist.get(op))
        print(f"  sass class {W} {'float64' if m.group(1) == 'd' else 'float32'}: "
              f"{sum(hist.values())} instructions over {piv} pivots; a pivot: {per}",
              flush=True)


def spd(batch, n, dtype, rng):
    import torch
    X = rng.standard_normal((batch, n, n))
    A = X @ np.swapaxes(X, -1, -2) / n + np.eye(n)
    bad = rng.random(batch) < 0.125
    A[bad] -= 10.0 * np.eye(n)
    return torch.as_tensor(A, dtype=getattr(torch, dtype), device="cuda")


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


def bind(so: Path, timed: bool):
    lib = ctypes.CDLL(str(so))
    I_, P_, L_ = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
    lib.px_chol_inv_factor.argtypes = [I_, P_, P_, L_, I_, P_] + ([P_] if timed else [])
    lib.px_chol_inv_factor.restype = I_
    return lib


def finish(jobs):
    """Wait for build jobs; their ptxas logs."""
    logs = []
    for so, p in jobs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {so}:\n{log}")
        logs.append(log)
    return logs


def run(name, jobs, logs, built_s):
    """Report the builds of jobs (as the port builds it, then with the
    stamps). The wrapper is timed on the library just built (it replaces
    the port's loaded one)."""
    import torch
    from piccolax_torch import _kernels
    from piccolax_torch.solver import kkt
    print(f"== {name}: built in {built_s:.1f} s", flush=True)
    for kern, regs, spill, frame in ptxas_summary(logs[0]):
        print(f"  ptxas {kern}: {regs} registers, {spill} bytes spilled, {frame} bytes "
              f"stack frame", flush=True)
    report_sass(jobs[0][0], name.startswith("baseline"))
    lib, tlib = bind(jobs[0][0], False), bind(jobs[1][0], True)
    _kernels._LIBS["chol_inv"] = lib
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rng = np.random.default_rng(5)
    for label, batch, n, dtype, launches in SHAPES:
        A = spd(batch, n, dtype, rng)
        Xi = torch.empty_like(A)
        eye = torch.eye(n, dtype=A.dtype, device="cuda").expand_as(A)
        f64 = int(dtype == "float64")

        def raw():
            rc = lib.px_chol_inv_factor(f64, A.data_ptr(), Xi.data_ptr(), batch, n, stream)
            if rc:
                raise RuntimeError(f"px_chol_inv_factor failed: {rc}")

        ms = least_ms(raw)
        ref = kkt.chol_inv_factor_plain(A)
        nan_eq = torch.equal(torch.isnan(Xi).any(-1).any(-1), torch.isnan(ref).any(-1).any(-1))
        fin = torch.isfinite(ref)
        rel = ((Xi[fin].double() - ref[fin].double()).abs().max()
               / ref[fin].double().abs().max()).item()
        wr = least_ms(lambda: kkt.chol_inv_factor(A))
        plain = least_ms(lambda: kkt.chol_inv_factor_plain(A))
        library = least_ms(lambda: torch.linalg.solve_triangular(
            torch.linalg.cholesky_ex(A)[0], eye, upper=False))
        st = torch.full((8,), -1, dtype=torch.int64, device="cuda")
        rc = tlib.px_chol_inv_factor(f64, A.data_ptr(), Xi.data_ptr(), batch, n, stream,
                                     st.data_ptr())
        torch.cuda.synchronize()
        if rc:
            raise RuntimeError(f"px_chol_inv_factor (stamps) failed: {rc}")
        s = st.cpu().tolist()
        cyc = ", ".join(f"{STAMP_NAMES[i]} {s[i + 1] - s[i]}" for i in range(5)
                        if s[i] >= 0 and s[i + 1] >= 0)
        es = 8 if f64 else 4
        bound = 1e3 * 2 * batch * n * n * es / 3.35e12
        print(f"  K1 {label} {dtype}: raw launch {ms:.4f} ms, wrapper {wr:.4f} ms, plain "
              f"version {plain:.4f} ms, cholesky_ex + solve_triangular {library:.4f} ms; "
              f"bound {bound:.4f} ms "
              f"(bytes); {launches} launches on the paths; rel err vs plain {rel:.2e}, "
              f"NaN mask {'equal' if nan_eq else 'DIFFERS'}; first block's cycles: {cyc}; "
              f"its span {(s[7] - s[6]) / 1e3:.1f} us", flush=True)
        if not nan_eq or rel > (1e-9 if f64 else 1e-4):
            raise RuntimeError(f"K1 {label}: disagrees with the plain version")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path,
                    help="commit 9e52288's piccolax_torch/csrc, timed first through "
                         "scripts/k1_timing/pr9_k1_stamps.patch")
    ap.add_argument("--only-baseline", action="store_true", help="time the baseline alone")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k1_timing: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    out = ROOT / "piccolax_torch" / "_build" / "k1_timing"
    todo = []               # (name, sources, timed sources, build directory)
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
        todo.append(("baseline (9e52288; stamps by pr9_k1_stamps.patch)", args.baseline, tdir,
                     out / "baseline"))
    if not args.only_baseline:
        todo.append(("piccolax_torch/csrc", CSRC, CSRC, out / "current"))
    t0 = time.perf_counter()           # every build side by side
    jobs = [[build(src, o, False), build(tsrc, o, True)] for _, src, tsrc, o in todo]
    logs = [finish(j) for j in jobs]
    for (name, *_), j, lg in zip(todo, jobs, logs):
        run(name, j, lg, time.perf_counter() - t0)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
