#!/usr/bin/env python3
"""Per-knot phase times of K7 (the qd KKT factor and solve) on the card.

Builds a K7 source with nvcc -DPX_QD_TIMING (the compile-time switch of the
clock64() stamps; off in every other build) and -Xptxas -v, prints the
registers, shared memory and spills of each kernel, then runs the timed
entry points at each shape and prints, per phase of a knot, the mean SM
cycles and microseconds over knots 1..N-1 of problem 0, the launch's time
(CUDA events over 5 launches without stamps, so only the switch's own
barriers remain) and the check against the plain PyTorch version.

Run from the root of a checkout on a machine with the card:

    python3 scripts/k7_phase_timing.py            # piccolax_torch/csrc/qd.cu
    git show 0e1cd8d:piccolax_torch/csrc/qd.cu > .chipcheck/qd_pr3.cu
    python3 scripts/k7_phase_timing.py --baseline .chipcheck/qd_pr3.cu

--baseline times the earlier design (one lane a row, K1's shared-memory
warp Cholesky, blocks up to 32 wide) as well, first: the given copy of its
qd.cu with scripts/k7_timing/pr3_stamps.patch applied (the same stamps,
with the factor's cap lifted to 64). Under PX_QD_TIMING each source's
px_qd_factor and px_qd_solve take the stamps' buffer after the stream, and
px_qd_timing_phases names the stamps.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SOURCE = ROOT / "piccolax_torch" / "csrc" / "qd.cu"
BASELINE_PATCH = ROOT / "scripts" / "k7_timing" / "pr3_stamps.patch"
# (B, N, dz, m, dtype): the quickstart's f64 blocks at B = 1 and 256,
# config 1's f32 blocks, and the CNOT's in both types
SHAPES = [(1, 100, 15, 13, "float64"), (256, 100, 15, 13, "float64"),
          (256, 50, 14, 12, "float32"), (16, 200, 44, 40, "float32"),
          (1, 200, 44, 40, "float64")]


def apply_patch(src: str, patch: str) -> str:
    """src with a unified diff made without context lines (diff -U0)
    applied; raises if a removed line does not match."""
    lines = src.splitlines(keepends=True)
    hunks = []
    for block in re.split(r"(?m)^(?=@@ )", patch)[1:]:
        head, *body = block.splitlines(keepends=True)
        a, b = re.match(r"@@ -(\d+)(?:,(\d+))?", head).groups()
        a, b = int(a), 1 if b is None else int(b)
        old = [ln[1:] for ln in body if ln.startswith("-")]
        new = [ln[1:] for ln in body if ln.startswith("+")]
        start = a if b == 0 else a - 1
        if lines[start:start + b] != old:
            raise ValueError(f"patch hunk at line {a} does not match the source")
        hunks.append((start, b, new))
    for start, b, new in reversed(hunks):
        lines[start:start + b] = new
    return "".join(lines)


def build(src: Path, out: Path) -> str:
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = "nvcc" if subprocess.run(["which", "nvcc"], capture_output=True).returncode == 0 \
        else "/usr/local/cuda/bin/nvcc"
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
           "-shared", "-Xcompiler", "-fPIC", "-DPX_QD_TIMING", "-Xptxas", "-v",
           "-I", str(ROOT / "piccolax_torch" / "csrc"), "-o", str(out), str(src)]
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{p.stdout}\n{p.stderr}")
    return p.stdout + p.stderr


def ptxas_summary(log: str) -> list[str]:
    """The kernel-name, register and spill lines of ptxas -v."""
    keep, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif name and ("registers" in line or "spill" in line):
            keep.append(f"{name}: {line.split('ptxas info    :')[-1].strip()}")
    return keep


def group_times(stamps: np.ndarray, names: list[str]):
    """Mean cycles per phase, knots 1..N-1 in the order they ran. A phase
    lasts from the previous stamped phase of its group (in time) to its own
    stamp; the group's first phase is its knot's start, and 'tail' runs from
    the last stamp of a knot to the next knot's start."""
    groups: dict[str, list[int]] = {}
    for i, n in enumerate(names):
        groups.setdefault(n.split(".")[0], []).append(i)
    result = {}
    for g, idx in groups.items():
        start = idx[0]
        knots = [k for k in range(stamps.shape[0]) if stamps[k, start] >= 0]
        knots.sort(key=lambda k: stamps[k, start])
        sums = {names[i]: [] for i in idx[1:]}
        sums[f"{g}.tail"] = []
        period = []
        for a, k in enumerate(knots):
            if k == 0 or a + 1 >= len(knots):
                continue
            prev = stamps[k, start]
            for i in idx[1:]:
                if stamps[k, i] >= 0:
                    sums[names[i]].append(stamps[k, i] - prev)
                    prev = stamps[k, i]
            nxt = stamps[knots[a + 1], start]
            sums[f"{g}.tail"].append(nxt - prev)
            period.append(nxt - stamps[k, start])
        result[g] = ({k: float(np.mean(v)) if v else 0.0 for k, v in sums.items()},
                     float(np.mean(period)) if period else 0.0)
    return result


def run(lib, B, N, dz, m, dtype, reps=5):
    import torch
    from chip_smoke import _qd_inputs, _time_ms
    from piccolax_torch.solver import kkt

    rng = np.random.default_rng(7)
    P, C, R, Cn, rhs = _qd_inputs(B, N, dz, m, dtype, rng)
    is64 = int(dtype == "float64")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    names = [lib.px_qd_timing_phases(w).decode().split(",") for w in (0, 1)]
    Pinv = torch.empty_like(P)
    Sinv = torch.empty(B, N, m, m, dtype=P.dtype, device="cuda")
    x = torch.empty_like(rhs)

    def factor(st=None):
        return lib.px_qd_factor(is64, P.data_ptr(), C.data_ptr(), R.data_ptr(),
                                Cn.data_ptr(), Pinv.data_ptr(), Sinv.data_ptr(),
                                B, N, m, dz, stream, st)

    def solve(st=None):
        return lib.px_qd_solve(is64, Pinv.data_ptr(), Sinv.data_ptr(), C.data_ptr(),
                               Cn.data_ptr(), rhs.data_ptr(), x.data_ptr(), B, N, m,
                               dz, 1, stream, st)

    fp = kkt.qd_factor_plain(P, C, R, Cn)
    refs = {"factor": (lambda: torch.cat([Pinv.flatten(1), Sinv.flatten(1)], 1),
                       torch.cat([t.flatten(1) for t in fp], 1)),
            "solve": (lambda: x, kkt.qd_solve_plain(fp, C, Cn, rhs, dz))}
    out = {}
    for what, fn, nm in (("factor", factor, names[0]), ("solve", solve, names[1])):
        stamps = torch.full((N, len(nm)), -1, dtype=torch.int64, device="cuda")
        rc = fn(stamps.data_ptr())
        torch.cuda.synchronize()
        if rc != 0:
            out[what] = {"refused": rc}
            break
        got, ref = refs[what][0](), refs[what][1]
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        ms = _time_ms(lambda: fn(None), reps)
        s = stamps.cpu().numpy()
        span = s[s >= 0].max() - s[s >= 0].min()
        cyc_per_us = span / (1e3 * ms)
        out[what] = {
            "ms": ms, "rel_err_vs_plain": rel, "cycles_per_us": cyc_per_us,
            "groups": {g: {"phases_cycles": ph, "knot_cycles": per,
                           "knot_us": per / cyc_per_us}
                       for g, (ph, per) in group_times(s, nm).items()}}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path,
                    help="a copy of PR 3's piccolax_torch/csrc/qd.cu to time first")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k7_phase_timing: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    out_dir = ROOT / "piccolax_torch" / "_build" / "timing"
    sources = [SOURCE]
    if args.baseline:
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / "qd_pr3_stamped.cu"
        path.write_text(apply_patch(args.baseline.read_text(), BASELINE_PATCH.read_text()))
        sources.insert(0, path)
    for path in sources:
        src = path.relative_to(ROOT)
        so = out_dir / f"{path.stem}_{os.getpid()}.so"
        t0 = time.perf_counter()
        log = build(path, so)
        print(f"== {src}: built in {time.perf_counter() - t0:.1f} s", flush=True)
        for line in ptxas_summary(log):
            print("  ptxas", line, flush=True)
        lib = ctypes.CDLL(str(so))
        lib.px_qd_timing_phases.restype = ctypes.c_char_p
        lib.px_qd_timing_phases.argtypes = [ctypes.c_int]
        P_, I_ = ctypes.c_void_p, ctypes.c_int
        lib.px_qd_factor.argtypes = [I_] + [P_] * 6 + [I_] * 4 + [P_, P_]
        lib.px_qd_solve.argtypes = [I_] + [P_] * 6 + [I_] * 5 + [P_, P_]
        lib.px_qd_factor.restype = lib.px_qd_solve.restype = I_
        for shape in SHAPES:
            key = "B={},N={},dz={},m={} {}".format(*shape)
            for what, v in run(lib, *shape).items():
                if "refused" in v:
                    print(f"  {key} {what}: refused (error {v['refused']})", flush=True)
                    continue
                print(f"  {key} {what}: {v['ms']:.4f} ms per launch, rel err vs plain "
                      f"{v['rel_err_vs_plain']:.2e}, {v['cycles_per_us']:.0f} cycles/us",
                      flush=True)
                for g, d in v["groups"].items():
                    ph = ", ".join(f"{n.split('.', 1)[1]} {c:.0f}"
                                   for n, c in d["phases_cycles"].items())
                    print(f"    {g}: {d['knot_cycles']:.0f} cycles = "
                          f"{d['knot_us']:.2f} us per knot: {ph}", flush=True)
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True,
                            text=True).stdout.strip()
    print(f"SM clock now, max: {clocks}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
