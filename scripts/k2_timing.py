#!/usr/bin/env python3
"""K2 (psd_clamp) on the card: time per sweep, fixed cost and SASS counts.

Builds csrc/psd_clamp.cu with nvcc -Xptxas -v into
piccolax_torch/_build/k2_timing/, prints each kernel's registers, spills
and stack frame, counts the instructions of each kernel's hottest loop in
`cuobjdump -sass` (shared-memory loads LDS*, FFMA, DFMA, DMMA, and all
instructions: the loop between a backward branch and its target that
holds the most multiply-adds), then at config 1's, the batched
quickstart's, config 3's and the CNOT's shapes times the kernel (CUDA
events) at the path's sweeps and at twice them, which gives the cost per
sweep and the fixed cost, and checks it against the plain version (the
largest difference over the largest plain entry).

Run from the root of a checkout on a machine with the card:

    python3 scripts/k2_timing.py
    mkdir -p .chipcheck/pr7 && git archive b34c8df piccolax_torch/csrc | tar -x -C .chipcheck/pr7
    python3 scripts/k2_timing.py --baseline .chipcheck/pr7/piccolax_torch/csrc

--baseline DIR times that directory's psd_clamp.cu first (both builds in
one process, in turns, so that the two are compared on one card).
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

CSRC = ROOT / "piccolax_torch" / "csrc"
# (B, N, n, dtype, sweeps, floor_rel): config 1, the batched quickstart,
# config 3, the CNOT (the IPM's clamp_iters and hess floor of each path)
SHAPES = [(256, 50, 14, "float32", 15, 3e-3), (256, 100, 15, "float64", 32, 1e-6),
          (16, 200, 44, "float32", 20, 3e-3), (1, 200, 44, "float64", 32, 1e-6)]
OPS = ("LDS", "FFMA", "DFMA", "DMMA")


def nvcc_path(tool: str = "nvcc") -> str:
    found = subprocess.run(["which", tool], capture_output=True, text=True).stdout.strip()
    return found or f"/usr/local/cuda/bin/{tool}"


def build(src_dir: Path, out: Path) -> str:
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(src_dir),
           "-o", str(out), str(src_dir / "psd_clamp.cu")]
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{p.stdout}\n{p.stderr}")
    return p.stdout + p.stderr


def ptxas_lines(log: str) -> list[str]:
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif name and "Used" in line and "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
            name = None
        elif name and "stack frame" in line:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def sass_loops(so: Path) -> list[tuple[str, int, dict]]:
    """(function, loop length, op counts) of each function's loop with the
    most multiply-adds; (function, 0, whole-function counts) where no
    backward branch is found."""
    text = subprocess.run([nvcc_path("cuobjdump"), "-sass", str(so)], capture_output=True,
                          text=True).stdout
    out = []
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name = block.splitlines()[0].strip()
        ins = []
        for line in block.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)", line)
            if m:
                ins.append((int(m.group(1), 16), m.group(2), m.group(3)))

        def counts(seg):
            c = {op: sum(1 for _, o, _ in seg if o.startswith(op)) for op in OPS}
            c["all"] = len(seg)
            hist = {}
            for _, o, _ in seg:
                hist[o] = hist.get(o, 0) + 1
            c["top"] = " ".join(f"{o}:{k}" for o, k in sorted(hist.items(), key=lambda kv: -kv[1])[:10])
            return c

        best = None
        for i, (addr, op, rest) in enumerate(ins):
            t = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
            if t and int(t.group(1), 16) < addr:
                seg = [x for x in ins if int(t.group(1), 16) <= x[0] <= addr]
                c = counts(seg)
                key = c["FFMA"] + c["DFMA"] + 256 * c["DMMA"]
                if best is None or key > best[0]:
                    best = (key, len(seg), c)
        out.append((name, best[1], best[2]) if best else (name, 0, counts(ins)))
    return out


def bind(so: Path):
    lib = ctypes.CDLL(str(so))
    I_, P_, L_, D_ = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double
    lib.px_psd_clamp.argtypes = [I_, P_, P_, L_, I_, I_, I_, D_, P_]
    lib.px_psd_clamp.restype = I_
    return lib


def time_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, help="a directory holding an earlier "
                    "piccolax_torch/csrc, timed first")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k2_timing: no CUDA device", file=sys.stderr)
        return 2
    from piccolax_torch.solver import kkt
    card = card_line()
    print(card, flush=True)
    out_dir = ROOT / "piccolax_torch" / "_build" / "k2_timing"
    builds = ([("baseline", args.baseline)] if args.baseline else []) + [("current", CSRC)]
    libs = {}
    for name, src in builds:
        t0 = time.perf_counter()
        so = out_dir / name / "libpsd_clamp.so"
        log = build(src, so)
        print(f"== {name} ({src}): built in {time.perf_counter() - t0:.1f} s", flush=True)
        for line in ptxas_lines(log):
            print(f"  ptxas {line}", flush=True)
        for fn, n, c in sass_loops(so):
            where = f"hottest loop, {n} instructions" if n else "whole function (no loop found)"
            print(f"  sass {fn}: {where}: " + ", ".join(f"{k} {v}" for k, v in c.items()),
                  flush=True)
        libs[name] = bind(so)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rng = np.random.default_rng(5)
    for B, N, n, dtype, sweeps, floor_rel in SHAPES:
        W = rng.standard_normal((B, N, n, n))
        W = torch.as_tensor(0.5 * (W + np.swapaxes(W, -1, -2)), dtype=getattr(torch, dtype),
                            device="cuda")
        out = torch.empty_like(W)
        ref = kkt.psd_clamp_plain(W, floor_rel, sweeps, "pos")
        floor_c = float(kkt._clamp_floor(floor_rel, sweeps))
        line = []
        order = list(libs) + list(libs)[::-1]        # in turns: a, b, b, a
        times = {k: {1: [], 2: []} for k in libs}
        for k in order:
            lib = libs[k]
            for mult in (1, 2):
                def call(it=sweeps * mult, fc=float(kkt._clamp_floor(floor_rel, sweeps * mult))):
                    rc = lib.px_psd_clamp(int(dtype == "float64"), W.data_ptr(), out.data_ptr(),
                                          B * N, n, it, 0, fc, stream)
                    if rc:
                        raise RuntimeError(f"px_psd_clamp failed: {rc}")
                times[k][mult].append(time_ms(call, args.reps))
        for k, lib in libs.items():
            rc = lib.px_psd_clamp(int(dtype == "float64"), W.data_ptr(), out.data_ptr(),
                                  B * N, n, sweeps, 0, floor_c, stream)
            torch.cuda.synchronize()
            assert rc == 0
            rel = ((out - ref).abs().max() / ref.abs().max()).item()
            t1, t2 = min(times[k][1]), min(times[k][2])
            per = (t2 - t1) / sweeps
            line.append(f"{k}: {t1:.4f} ms at {sweeps} sweeps, {t2:.4f} at {2 * sweeps} "
                        f"(per sweep {1e3 * per:.2f} us, fixed {1e3 * (t1 - sweeps * per):.2f} us; "
                        f"rel err vs plain {rel:.1e})")
        print(f"K2 [{B},{N},{n},{n}] {dtype}: " + "; ".join(line), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
