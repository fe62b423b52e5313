#!/usr/bin/env python3
"""Phase times of K3's condensed factor and K9's partition factor on the card.

Builds csrc/condensed_cr.cu and csrc/knot.cu with nvcc -DPX_CR_TIMING (the
compile-time switch of the stamps; off in every other build) and
-Xptxas -v, prints each kernel's registers, spills and static shared
memory, then runs the timed entry points (px_cr_factor and px_knot_factor
take the stamps' buffer after the stream under the switch) at each shape
and prints the factor's time (CUDA events over 5 launches without
stamps), its largest relative difference from the plain version (by
factor plane) and where the time goes. K3's float32 shapes run the
factor the paths run: float64 levels, the factor stored in float32. The factor is a sequence of
launches, a thread block a row (common.cuh): for each launch, kind and
level, the time from its first thread block's start to the next launch's
(%globaltimer) and the clock64() cycles of that block's phases; then the
totals by kind.

Run from the root of a checkout on a machine with the card:

    python3 scripts/cr_phase_timing.py
    mkdir -p .chipcheck/pr6 && git archive 1f359b2 piccolax_torch/csrc | tar -x -C .chipcheck/pr6
    python3 scripts/cr_phase_timing.py --baseline .chipcheck/pr6/piccolax_torch/csrc

--baseline also times, first, the one-block-per-problem design of that
commit: its sources with scripts/cr_timing/pr6_stamps.patch applied (one
thread block a problem, or a partition, whose clock64() stamps split it
into the condensation, each level's Cholesky inverses, Gl/Gr and Dn/Un
products, and K9's SPIKE solve and interface rows).

--knot-solve times K9's condensed solve (csrc/knot.cu alone, from
factors made by the plain version) at ck8's shapes (B = 1, float64, P = 8
and 4) and at B = 16, float32, P = 8: the solve's time (CUDA events), its
largest relative difference from the plain solve and, for each of its
three launches ((c1) the partitions' dual right-hand sides, interior CR
solves and interface rows; (c2) the interface solves; (c3) x_int and the
primal recovery), its thread blocks and cluster size, the first block's
span from start to end (%globaltimer) and its clock64() cycles by phase
(each stamp taken after the phase's barrier). With --baseline DIR (commit
9e52288's piccolax_torch/csrc: mkdir -p .chipcheck/pr9 && git archive
9e52288 piccolax_torch/csrc | tar -x -C .chipcheck/pr9) it first times
that commit's one-block-a-partition solve through
scripts/cr_timing/pr9_knot_solve_stamps.patch.

--solve times K3's condensed solve instead (csrc/cr_solve.cu alone, from
factors made by the plain version): at the same four shapes, the solve's
time (CUDA events), its largest relative difference from the plain solve
and the clock64() cycles, on the first thread block of the first problem,
of its phases: the dual right-hand side, each reduction level, the root,
each back-substitution level and the primal recovery (each stamp taken
after the phase's barrier, so a cluster's slowest block sets it), and
within each phase's first chunk the cycles until its operands arrived
(load), of its three mat-vec steps (mv1-mv3) and the rest (its other
chunks, the next phase's staging and the barrier). With --baseline DIR (commit b34c8df's piccolax_torch/csrc:
mkdir -p .chipcheck/pr7 && git archive b34c8df piccolax_torch/csrc |
tar -x -C .chipcheck/pr7) it first times the one-block-a-problem solve of
that commit through scripts/cr_timing/pr7_solve_stamps.patch.
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

CSRC = ROOT / "piccolax_torch" / "csrc"
BASELINE_PATCH = ROOT / "scripts" / "cr_timing" / "pr6_stamps.patch"
SOLVE_PATCH = ROOT / "scripts" / "cr_timing" / "pr7_solve_stamps.patch"
KNOT_SOLVE_PATCH = ROOT / "scripts" / "cr_timing" / "pr9_knot_solve_stamps.patch"
SOURCES = ("condensed_cr", "knot")
# K3: (B, N, dz, m, dtype): config 3, the CNOT, the batched quickstart,
# config 1. K9: the CNOT's blocks, P = 8 and 4, both types.
K3_SHAPES = [(16, 200, 44, 40, "float32"), (1, 200, 44, 40, "float64"),
             (256, 100, 15, 13, "float64"), (256, 50, 14, 12, "float32")]
K9_SHAPES = [(1, 200, 44, 40, "float64", 8), (1, 200, 44, 40, "float64", 4),
             (16, 200, 44, 40, "float32", 8), (16, 200, 44, 40, "float32", 4)]
# K9's solve: the CNOT's blocks, B = 1 float64 at P = 8 and 4 (ck8's
# shapes), B = 16 float32 at P = 8
K9_SOLVE_SHAPES = [(1, 200, 44, 40, "float64", 8), (1, 200, 44, 40, "float64", 4),
                   (16, 200, 44, 40, "float32", 8)]
KNOT_LAUNCH = 256  # stamp slots of each of K9's solve launches
STAMPS = 8192  # int64 slots of a call's buffer (8 a launch in the current design)
SUB = 64       # the solve's first sub-phase stamp (cr_solve.cu: kSubStamps)


def split_patch(patch: str) -> dict[str, str]:
    """A multi-file unified diff, by the file name of its '+++ b/' lines."""
    files = {}
    for block in re.split(r"(?m)^(?=--- )", patch):
        m = re.search(r"(?m)^\+\+\+ b/(\S+)", block)
        if m:
            files[Path(m.group(1)).name] = block
    return files


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


def nvcc() -> str:
    found = subprocess.run(["which", "nvcc"], capture_output=True, text=True).stdout.strip()
    return found or "/usr/local/cuda/bin/nvcc"


def build_all(src_dir: Path, out_dir: Path, sources=SOURCES) -> dict[str, tuple[Path, str]]:
    """Every source of `sources` in src_dir, stamped, one nvcc each, all at
    once; (library, ptxas log) by name."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in sources:
        so = out_dir / f"{name}_{os.getpid()}.so"
        cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
               "-shared", "-Xcompiler", "-fPIC", "-DPX_CR_TIMING", "-Xptxas", "-v",
               "-I", str(src_dir), "-o", str(so), str(src_dir / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    out = {}
    for name, (p, so) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        out[name] = (so, log)
    return out


def ptxas_summary(log: str) -> list[tuple[str, int, int, int]]:
    """(kernel, registers, spill bytes, stack frame bytes) of each entry
    function that ptxas -v reports."""
    rows, name, frame, spill = [], None, 0, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif name and "stack frame" in line:
            frame = int(re.search(r"(\d+) bytes stack frame", line).group(1))
            spill = sum(int(x) for x in re.findall(r"(\d+) bytes spill", line))
        elif name and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            rows.append((name, regs, spill, frame))
            name, frame, spill = None, 0, 0
    return rows


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def levels(n: int) -> int:
    return max(0, (n - 1).bit_length())


def phases_cr(s, base, Np, tag):
    """The CR level loop's stamps from s[base]: chol, Gl/Gr, Dn/Un per
    level, then the root; (name, slot) pairs."""
    out = []
    for lv in range(levels(Np)):
        out += [(f"{tag}L{lv}.chol", base + 3 * lv), (f"{tag}L{lv}.G", base + 3 * lv + 1),
                (f"{tag}L{lv}.DU", base + 3 * lv + 2)]
    out.append((f"{tag}root", base + 3 * levels(Np)))
    return out


def baseline_k3(Np):
    return [("Y/Yn", 1), ("D/U", 2), ("pad", 3)] + phases_cr(None, 4, Np, "")


def baseline_k9(N, P):
    from piccolax_torch.solver.kkt import _pow2_pad
    k = N // P - 2
    Npk, Npi = _pow2_pad(k), _pow2_pad(2 * P)
    sp = 4 + 3 * levels(Npk) + 1
    part = [("Y/Yn", 1), ("D/U", 2), ("pad", 3)] + phases_cr(None, 4, Npk, "") + \
        [("spike.init", sp), ("spike.reduce", sp + 1), ("spike.root", sp + 2),
         ("spike.back", sp + 3), ("iface.rows", sp + 4)]
    iface = [("if.pad", 64 + 1)] + phases_cr(None, 64 + 2, Npi, "if.")
    return part, iface


def durations(s: np.ndarray, layout, start: int):
    """Cycles of each phase of layout from the stamp before it (start for
    the first); phases whose stamp is missing are skipped."""
    out, prev = [], s[start]
    for name, slot in layout:
        if s[slot] < 0:
            continue
        out.append((name, int(s[slot] - prev)))
        prev = s[slot]
    return out, int(prev - s[start])


def summarize(ph):
    """Totals by kind: condensation, Cholesky, products, SPIKE, rest."""
    tot = {}
    for name, c in ph:
        leaf = name.split(".")[-1]
        kind = ("condense" if name in ("Y/Yn", "D/U") else
                "chol" if leaf in ("chol", "root") else
                "products" if leaf in ("G", "DU") else
                "spike solve" if name.startswith("spike.") and leaf != "init" else "other")
        tot[kind] = tot.get(kind, 0) + c
    return tot


def time_ms(fn, reps=5):
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


def run_k3(lib, B, N, dz, m, dtype, baseline):
    import torch
    from chip_smoke import _qd_inputs
    from piccolax_torch.solver import kkt
    rng = np.random.default_rng(7)
    P, C, R, Cn, _ = _qd_inputs(B, N, dz, m, dtype, rng)
    Xi = kkt.chol_inv_factor_plain(P).contiguous()   # (solve_triangular's is column-major)
    Np = kkt._pow2_pad(N)
    cr = torch.empty(B, 3, Np, m, m, dtype=P.dtype, device="cuda")
    ws = torch.empty(B * lib.px_cr_factor_ws(N, Np, m, dz), dtype=torch.float64,
                     device="cuda")  # float64 elements (a float32-workspace build needs half)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    st = torch.full((STAMPS,), -1, dtype=torch.int64, device="cuda")

    def call(ptr):
        rc = lib.px_cr_factor(int(dtype == "float64"), Xi.data_ptr(), C.data_ptr(),
                              R.data_ptr(), Cn.data_ptr(), cr.data_ptr(), ws.data_ptr(),
                              B, N, Np, m, dz, stream, ptr)
        if rc:
            raise RuntimeError(f"px_cr_factor failed: {rc}")

    call(None)                                  # load the kernels and warm the caches
    call(st.data_ptr())
    torch.cuda.synchronize()
    ref = kkt.condense_cr_factor_plain(Xi, C, R, Cn)
    rel = rel_by(cr, ref, ("Xi", "Ul", "Ur"))
    kinds = None if baseline else timing_kinds(lib)
    ms = time_ms(lambda: call(None))
    s = st.cpu().numpy()
    if baseline:
        ph, total = durations(s, baseline_k3(Np), 0)
        return ms, rel, [("K3", ph, total)]
    return ms, rel, launches(s, kinds)


def run_k9(lib, B, N, dz, m, dtype, P, baseline):
    import torch
    from chip_smoke import _qd_inputs
    from piccolax_torch.parallel import sharded_kkt as sk
    from piccolax_torch.solver import kkt
    rng = np.random.default_rng(41)
    Pm, C, R, Cn, _ = _qd_inputs(B, N, dz, m, dtype, rng)
    Xi = kkt.chol_inv_factor_plain(Pm).contiguous()
    f = sk._factor_buffers(C, B, N, P, m)
    ws = torch.empty(lib.px_knot_factor_ws(B, N, P, m, dz), dtype=C.dtype, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    st = torch.full((STAMPS,), -1, dtype=torch.int64, device="cuda")

    def call(ptr):
        rc = lib.px_knot_factor(int(dtype == "float64"), Xi.data_ptr(), C.data_ptr(),
                                R.data_ptr(), Cn.data_ptr(), f["fT"].data_ptr(),
                                f["spike"].data_ptr(), f["Ub"].data_ptr(),
                                f["f_if"].data_ptr(), ws.data_ptr(), B, N, P, m, dz,
                                stream, ptr)
        if rc:
            raise RuntimeError(f"px_knot_factor failed: {rc}")

    call(None)
    call(st.data_ptr())
    torch.cuda.synchronize()
    ref = sk.knot_condense_factor_plain(Xi, C, R, Cn, P)
    errs = {k: ((f[k] - ref[k]).abs().max() / ref[k].abs().max()).item()
            for k in ("fT", "spike", "Ub", "f_if")}
    rel = (max(errs.values()), ", ".join(f"{k} {v:.1e}" for k, v in errs.items()))
    kinds = None if baseline else timing_kinds(lib)
    ms = time_ms(lambda: call(None))
    s = st.cpu().numpy()
    if baseline:
        part, iface = baseline_k9(N, P)
        a, ta = durations(s, part, 0)
        b, tb = durations(s, iface, 64)
        return ms, rel, [("K9 partition", a, ta), ("K9 interface", b, tb)]
    return ms, rel, launches(s, kinds)


def timing_kinds(lib):
    buf = (ctypes.c_int * 1024)()
    n = lib.px_cr_timing_kinds(buf)
    return [buf[i] for i in range(n)]


# launch kinds of the current design (px_cr_timing_kinds) and the names of
# the first thread block's three phases in each
KINDS = {0: ("condense", ("Y", "D", "U")), 1: ("elim", ("chol", "copy", "Gl|Gr")),
         2: ("update", ("Dn1", "Dn2|Un", "-")), 3: ("root", ("chol", "copy", "-")),
         5: ("spike.odd", ("q", "tl", "-")), 6: ("spike.even", ("p1", "p2", "-")),
         7: ("spike.root", ("q", "x", "-")), 8: ("spike.back", ("t", "y", "-")),
         9: ("iface.rows", ("D", "U", "copy"))}


def launches(s: np.ndarray, kinds):
    """(kind name, level, wall us, phase cycles) of each launch: wall from
    its first block's start to the next launch's first block's start (the
    last to its own end)."""
    out = []
    for q, kl in enumerate(kinds):
        k, lvl = kl % 256, kl // 256
        g0 = s[8 * q + 1]
        g1 = s[8 * (q + 1) + 1] if q + 1 < len(kinds) else s[8 * q + 6]
        c = [s[8 * q + i] for i in (2, 3, 4, 5)]
        name, ph = KINDS[k]
        out.append((name, lvl, (g1 - g0) / 1e3,
                    [(ph[i], int(c[i + 1] - c[i])) for i in range(3) if ph[i] != "-"]))
    return out


def report_launches(lst, total_ms):
    by = {}
    for name, _, us, ph in lst:
        d = by.setdefault(name, [0, 0.0, {}])
        d[0] += 1
        d[1] += us
        for pn, c in ph:
            d[2][pn] = d[2].get(pn, 0) + c
    wall = sum(v[1] for v in by.values())
    print(f"    {len(lst)} launches, {wall:.1f} us first block to last end "
          f"(events: {1e3 * total_ms:.1f} us)", flush=True)
    for name, (n, us, ph) in sorted(by.items(), key=lambda kv: -kv[1][1]):
        phs = ", ".join(f"{k} {v}" for k, v in ph.items())
        print(f"      {name}: {n} launches, {us:.1f} us ({100 * us / max(wall, 1e-9):.1f}%); "
              f"first block's cycles: {phs}", flush=True)
    print("      by launch: " + "; ".join(
        f"{name}[{lvl}] {us:.1f} us (" + ", ".join(f"{k} {v}" for k, v in ph) + ")"
        for name, lvl, us, ph in lst), flush=True)


def rel_by(got, ref, names):
    """Largest difference over the largest reference entry, whole and by
    the leading index (factor plane)."""
    whole = ((got - ref).abs().max() / ref.abs().max()).item()
    parts = ", ".join(f"{n} {((got[:, i] - ref[:, i]).abs().max() / ref.abs().max()).item():.1e}"
                      for i, n in enumerate(names))
    return whole, parts


def bind(k3, k9):
    I_, P_, L_ = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
    for lib in (k3, k9):
        if hasattr(lib, "px_cr_timing_kinds"):
            lib.px_cr_timing_kinds.argtypes = [P_]
            lib.px_cr_timing_kinds.restype = I_
    k3.px_cr_factor.argtypes = [I_] + [P_] * 6 + [I_] * 5 + [P_, P_]
    k3.px_cr_factor_ws.argtypes = [I_] * 4
    k3.px_cr_factor_ws.restype = L_
    k9.px_knot_factor.argtypes = [I_] + [P_] * 9 + [I_] * 5 + [P_, P_]
    k9.px_knot_factor_ws.argtypes = [I_] * 5
    k9.px_knot_factor_ws.restype = L_


def report(name, libs, baseline, cyc_note):
    print(f"== {name}", flush=True)
    for src, (so, log) in libs.items():
        for kern, regs, spill, frame in ptxas_summary(log):
            print(f"  ptxas {src}: {kern}: {regs} registers, {spill} bytes spilled, "
                  f"{frame} bytes stack frame", flush=True)
    k3 = ctypes.CDLL(str(libs["condensed_cr"][0]))
    k9 = ctypes.CDLL(str(libs["knot"][0]))
    bind(k3, k9)
    runs = [("K3", shape, lambda sh=shape: run_k3(k3, *sh, baseline)) for shape in K3_SHAPES]
    runs += [("K9", shape, lambda sh=shape: run_k9(k9, *sh, baseline)) for shape in K9_SHAPES]
    for what, shape, fn in runs:
        ms, (rel, parts), groups = fn()
        key = "B={},N={},dz={},m={} {}".format(*shape[:5]) + \
            (f" P={shape[5]}" if len(shape) > 5 else "")
        print(f"  {what} {key}: {ms:.4f} ms per call, rel err vs plain {rel:.2e} "
              f"({parts})", flush=True)
        if not baseline:
            report_launches(groups, ms)
            continue
        for gname, ph, total in groups:
            tot = summarize(ph)
            share = ", ".join(f"{k} {v} ({100 * v / max(total, 1):.1f}%)"
                              for k, v in sorted(tot.items(), key=lambda kv: -kv[1]))
            print(f"    {gname}: {total} cycles ({total / cyc_note:.1f} us at "
                  f"{cyc_note:.0f}/us): {share}", flush=True)
            print("      " + ", ".join(f"{n} {c}" for n, c in ph), flush=True)


# ---------------------------------------------------------------------------
# --solve: K3's condensed solve by phase
# ---------------------------------------------------------------------------


def solve_phase_names(Np: int) -> list[str]:
    """The solve's stamped phases in order (stamps slot 1 onwards; slot 0
    is the start)."""
    L = levels(Np)
    return (["dual"] + [f"down{lv}" for lv in range(L)] + ["root"]
            + [f"up{lv}" for lv in reversed(range(L))] + ["primal"])


def run_solve(lib, B, N, dz, m, dtype, baseline, reps):
    """One shape: (ms, rel err, [(phase, cycles)], [(phase, sub-step cycles)])."""
    import torch
    from chip_smoke import _qd_inputs
    from piccolax_torch.solver import kkt
    rng = np.random.default_rng(7)
    P, C, R, Cn, rhs = _qd_inputs(B, N, dz, m, dtype, rng)
    Xi = kkt.chol_inv_factor_plain(P).contiguous()
    cr = kkt.condense_cr_factor_plain(Xi, C, R, Cn).contiguous()
    Np = kkt._pow2_pad(N)
    r = rhs.shape[-1]
    out = torch.empty_like(rhs)
    ws = torch.empty(B * lib.px_condensed_solve_ws(N, Np, m, dz, r), dtype=P.dtype,
                     device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    st = torch.full((STAMPS,), -1, dtype=torch.int64, device="cuda")
    lead = [int(dtype == "float64"), Xi.data_ptr(), C.data_ptr(), Cn.data_ptr(),
            cr.data_ptr(), rhs.data_ptr(), out.data_ptr(), ws.data_ptr(), B, N, Np, m, dz, r]

    def call(ptr):
        rc = lib.px_condensed_solve(*lead, stream, ptr)
        if rc:
            raise RuntimeError(f"px_condensed_solve failed: {rc}")

    call(None)
    call(st.data_ptr())
    torch.cuda.synchronize()
    ref = kkt.condensed_solve_plain((Xi, cr), C, Cn, rhs, dz)
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    ms = time_ms(lambda: call(None), reps)
    s = st.cpu().numpy()
    names = solve_phase_names(Np)
    ph = [(n, int(s[i + 1] - s[i])) for i, n in enumerate(names) if s[i + 1] >= 0 and s[i] >= 0]
    sub = []
    if not baseline:          # load, mv1, mv2, mv3, rest of each phase (-1: none)
        for i, n in enumerate(names):
            marks = [int(s[i])] + [int(x) for x in s[SUB + 4 * i: SUB + 4 * i + 4]] + [int(s[i + 1])]
            seen = [x for x in marks if x >= 0]
            cyc = []
            prev = marks[0]
            for x in marks[1:]:
                cyc.append(x - prev if x >= 0 else -1)
                prev = x if x >= 0 else prev
            sub.append((n, cyc if len(seen) > 2 else None))
    return ms, rel, ph, sub


def sass_hist(so: Path, key: str, top: int = 16):
    """The most frequent opcodes of each kernel of `so` whose name holds key
    (cuobjdump -sass)."""
    tool = subprocess.run(["which", "cuobjdump"], capture_output=True, text=True).stdout.strip()
    text = subprocess.run([tool or "/usr/local/cuda/bin/cuobjdump", "-sass", str(so)],
                          capture_output=True, text=True).stdout
    out = []
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name = block.splitlines()[0].strip()
        if key not in name:
            continue
        hist = {}
        for line in block.splitlines():
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if m:
                hist[m.group(1)] = hist.get(m.group(1), 0) + 1
        out.append((name, f"{sum(hist.values())} instructions; " + " ".join(
            f"{o}:{k}" for o, k in sorted(hist.items(), key=lambda kv: -kv[1])[:top])))
    return out


def report_solve(name, src_dir, out_dir, baseline, cyc_per_us):
    t0 = time.perf_counter()
    src = "condensed_cr" if baseline else "cr_solve"
    libs = build_all(src_dir, out_dir, (src,))
    print(f"== {name}: built in {time.perf_counter() - t0:.1f} s", flush=True)
    so, log = libs[src]
    for kern, regs, spill, frame in ptxas_summary(log):
        if "solve" in kern:
            print(f"  ptxas: {kern}: {regs} registers, {spill} bytes spilled, "
                  f"{frame} bytes stack frame", flush=True)
    for fn, top in sass_hist(so, "solve_kernel"):
        print(f"  sass {fn}: {top}", flush=True)
    lib = ctypes.CDLL(str(so))
    I_, P_, L_ = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
    lib.px_condensed_solve.argtypes = [I_] + [P_] * 7 + [I_] * 6 + [P_, P_]
    lib.px_condensed_solve_ws.argtypes = [I_] * 5
    lib.px_condensed_solve_ws.restype = L_
    if not baseline:
        lib.px_solve_config.argtypes = [P_]
        lib.px_solve_config.restype = None
    if not baseline:
        import torch
        lib.px_solve_mv_probe.argtypes = [I_, P_, I_, I_, P_]
        for dtype, m in (("float64", 40), ("float32", 40), ("float64", 13)):
            M = torch.randn(m, m, dtype=getattr(torch, dtype), device="cuda")
            o = torch.zeros(16, dtype=torch.int64, device="cuda")
            reps = 64
            if lib.px_solve_mv_probe(int(dtype == "float64"), M.data_ptr(), m, reps, o.data_ptr()):
                raise RuntimeError("px_solve_mv_probe failed")
            v = o.cpu().tolist()
            print(f"  probe {dtype} m={m}: a block mat-vec and barrier {v[0] / reps:.0f} cycles, "
                  f"a barrier {v[1] / reps:.0f}, a {m}-term dot on every thread "
                  f"{v[2] / reps:.0f}, on {m} threads {v[3] / reps:.0f}, a block mat-vec "
                  f"without barrier {v[4] / reps:.0f}", flush=True)
        sass = subprocess.run([(subprocess.run(["which", "cuobjdump"], capture_output=True,
                                               text=True).stdout.strip()
                                or "/usr/local/cuda/bin/cuobjdump"), "-sass", str(so)],
                              capture_output=True, text=True).stdout
        blocks = [b for b in re.split(r"\n(?=\s*Function : )", sass) if "mv_probe_kernelIdE" in b]
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "mv_probe_sass.txt").write_text("\n".join(blocks))
    for B, N, dz, m, dtype in K3_SHAPES:
        ms, rel, ph, sub = run_solve(lib, B, N, dz, m, dtype, baseline,
                                     20 if B > 1 and dtype == "float32" else 10)
        if not baseline:
            cfg = (ctypes.c_longlong * 3)()
            lib.px_solve_config(cfg)
            cl_note = f" [launched: cluster {cfg[2]}, {cfg[0] // 1024} KB shared a block, " \
                      f"{cfg[1]} clusters resident]"
        else:
            cl_note = ""
        total = sum(c for _, c in ph)
        by = {"dual": 0, "down": 0, "root": 0, "up": 0, "primal": 0}
        for n, c in ph:
            by[n.rstrip("0123456789")] += c
        share = ", ".join(f"{k} {v} ({100 * v / max(total, 1):.1f}%)" for k, v in by.items())
        print(f"  K3 solve B={B},N={N},dz={dz},m={m} {dtype}: {ms:.4f} ms per call, "
              f"rel err vs plain {rel:.2e}{cl_note}; first block {total} cycles "
              f"({total / cyc_per_us:.1f} us at {cyc_per_us:.0f}/us): {share}", flush=True)
        print("      " + ", ".join(f"{n} {c}" for n, c in ph), flush=True)
        if sub:
            print("      first chunk (load/mv1/mv2/mv3/rest): " + "; ".join(
                f"{n} " + "/".join(str(x) for x in cyc) for n, cyc in sub if cyc), flush=True)


# ---------------------------------------------------------------------------
# --knot-solve: K9's solve by launch and phase
# ---------------------------------------------------------------------------


def knot_solve_names(N: int, P: int, baseline: bool):
    """(launch, {stamp slot: phase}) of K9's three solve launches."""
    from piccolax_torch.solver.kkt import _pow2_pad
    Lk, Li = levels(_pow2_pad(N // P - 2)), levels(_pow2_pad(2 * P))

    def cr(L, tag):
        return ([f"{tag}down{lv}" for lv in range(L)] + [f"{tag}root"]
                + [f"{tag}up{lv}" for lv in reversed(range(L))])
    if baseline:          # one block a partition (c1, c3) and a problem (c2)
        return [("c1", {1: "dual", 2: "copy", **{3 + i: n for i, n in enumerate(cr(Lk, ""))},
                        61: "rf/rl"}),
                ("c2", {1: "zero", **{2 + i: n for i, n in enumerate(cr(Li, "if."))},
                        61: "copy"}),
                ("c3", {1: "x_int", 61: "primal"})]
    return [("c1", {1: "dual", **{2 + i: n for i, n in enumerate(cr(Lk, ""))},
                    3 + 2 * Lk: "rf/rl"}),
            ("c2", {1 + i: n for i, n in enumerate(cr(Li, "if."))}),
            ("c3", {1: "x_int and primal"})]


def run_knot_solve(lib, B, N, dz, m, dtype, P, baseline, reps):
    """One shape: (ms, rel err vs plain, [(launch, span us, [(phase, cycles)])],
    launch configs or None)."""
    import torch
    from chip_smoke import _qd_inputs
    from piccolax_torch.parallel import sharded_kkt as sk
    from piccolax_torch.solver import kkt
    rng = np.random.default_rng(41)
    Pm, C, R, Cn, rhs = _qd_inputs(B, N, dz, m, dtype, rng)
    Xi = kkt.chol_inv_factor_plain(Pm).contiguous()
    f = {k: v.contiguous() if torch.is_tensor(v) else v
         for k, v in sk.knot_condense_factor_plain(Xi, C, R, Cn, P).items()}
    r = rhs.shape[-1]
    out = torch.empty_like(rhs)
    ws = torch.empty(lib.px_knot_solve_ws(B, N, P, m, dz, r), dtype=rhs.dtype, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    st = torch.full((STAMPS,), -1, dtype=torch.int64, device="cuda")
    lead = [int(dtype == "float64"), Xi.data_ptr(), C.data_ptr(), Cn.data_ptr(),
            f["fT"].data_ptr(), f["spike"].data_ptr(), f["Ub"].data_ptr(), f["f_if"].data_ptr(),
            rhs.data_ptr(), out.data_ptr(), ws.data_ptr(), B, N, P, m, dz, r]

    def call(ptr):
        rc = lib.px_knot_solve(*lead, stream, ptr)
        if rc:
            raise RuntimeError(f"px_knot_solve failed: {rc}")

    call(None)
    call(st.data_ptr())
    torch.cuda.synchronize()
    ref = sk.knot_condensed_solve_plain(f, rhs, P, dz)
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    cfg = None
    if not baseline:
        c = (ctypes.c_longlong * 9)()
        lib.px_knot_solve_config(c)
        cfg = [tuple(c[3 * i: 3 * i + 3]) for i in range(3)]
    ms = time_ms(lambda: call(None), reps)
    s = st.cpu().numpy()
    launches = []
    for q, (name, slots) in enumerate(knot_solve_names(N, P, baseline)):
        b = s[q * KNOT_LAUNCH: (q + 1) * KNOT_LAUNCH]
        prev, ph, sub = b[0], [], []
        for slot in sorted(slots):
            if b[slot] >= 0:
                ph.append((slots[slot], int(b[slot] - prev)))
                if not baseline:      # the engine's first chunk of phase slot - 1
                    marks = [int(x) for x in b[SUB + 4 * (slot - 1): SUB + 4 * slot]]
                    seq = [int(prev)] + marks + [int(b[slot])]
                    if all(x >= 0 for x in marks):
                        sub.append((slots[slot], [seq[i + 1] - seq[i] for i in range(5)]))
                prev = b[slot]
        launches.append((name, (b[63] - b[62]) / 1e3, ph, sub))
    return ms, rel, launches, cfg


def report_knot_solve(name, libs, built_s, baseline, cyc_per_us, reps=10):
    print(f"== {name}: built in {built_s:.1f} s", flush=True)
    so, log = libs["knot"]
    for kern, regs, spill, frame in ptxas_summary(log):
        if "solve" in kern:
            print(f"  ptxas: {kern}: {regs} registers, {spill} bytes spilled, "
                  f"{frame} bytes stack frame", flush=True)
    lib = ctypes.CDLL(str(so))
    I_, P_, L_ = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
    lib.px_knot_solve.argtypes = [I_] + [P_] * 10 + [I_] * 6 + [P_, P_]
    lib.px_knot_solve_ws.argtypes = [I_] * 6
    lib.px_knot_solve_ws.restype = L_
    if not baseline:
        lib.px_knot_solve_config.argtypes = [P_]
        lib.px_knot_solve_config.restype = None
    for B, N, dz, m, dtype, P in K9_SOLVE_SHAPES:
        ms, rel, launches, cfg = run_knot_solve(lib, B, N, dz, m, dtype, P, baseline, reps)
        print(f"  K9 solve B={B},N={N},dz={dz},m={m} {dtype} P={P}: {ms:.4f} ms per call, "
              f"rel err vs plain {rel:.2e}", flush=True)
        for q, (lname, span, ph, sub) in enumerate(launches):
            if baseline:      # one thread block of 256 a partition (c1, c3) or problem (c2)
                blocks = B if lname == "c2" else B * P
                where = f"{blocks} thread blocks of 256, one a {'problem' if lname == 'c2' else 'partition'}"
            else:
                blocks, cluster, smem = cfg[q]
                where = f"{blocks} thread blocks in clusters of {cluster}, {smem // 1024} KB each"
            total = sum(c for _, c in ph)
            print(f"    {lname}: block 0 from start to end {span:.1f} us ({where}); "
                  f"its cycles {total} ({total / cyc_per_us:.1f} us): "
                  + ", ".join(f"{n} {c}" for n, c in ph), flush=True)
            if sub:
                print("      first chunk (load/mv1/mv2/mv3/rest): " + "; ".join(
                    f"{n} " + "/".join(str(x) for x in cyc) for n, cyc in sub), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path,
                    help="a directory holding commit 1f359b2's piccolax_torch/csrc, "
                         "to time first with its stamps patch")
    ap.add_argument("--only-baseline", action="store_true",
                    help="time the baseline alone")

    ap.add_argument("--knot-solve", action="store_true",
                    help="time K9's solve by launch and phase (--baseline: commit "
                         "9e52288's sources through pr9_knot_solve_stamps.patch)")
    ap.add_argument("--solve", action="store_true",
                    help="time K3's condensed solve by phase (--baseline: commit "
                         "b34c8df's sources through pr7_solve_stamps.patch)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("cr_phase_timing: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    out_dir = ROOT / "piccolax_torch" / "_build" / "cr_timing"
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout.strip()
    cyc_per_us = float(clk.splitlines()[0]) if clk else 1980.0
    if args.knot_solve:
        todo = []           # (name, sources, build directory, baseline)
        if args.baseline:
            bdir = out_dir / "knot_solve_baseline_src"
            bdir.mkdir(parents=True, exist_ok=True)
            patches = split_patch(KNOT_SOLVE_PATCH.read_text())
            for f in args.baseline.iterdir():
                if f.suffix in (".cu", ".cuh"):
                    text = f.read_text()
                    if f.name in patches:
                        text = apply_patch(text, patches[f.name])
                    (bdir / f.name).write_text(text)
            todo.append(("baseline K9 solve (9e52288 with pr9_knot_solve_stamps.patch)", bdir,
                         out_dir / "knot_solve_baseline", True))
        if not args.only_baseline:
            todo.append(("piccolax_torch/csrc K9 solve", CSRC, out_dir / "knot_solve_current",
                         False))
        from concurrent.futures import ThreadPoolExecutor
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(todo)) as pool:     # the builds side by side
            built = list(pool.map(lambda t: build_all(t[1], t[2], ("knot",)), todo))
        for (name, _, _, base), libs in zip(todo, built):
            report_knot_solve(name, libs, time.perf_counter() - t0, base, cyc_per_us)
        print(card, flush=True)
        return 0
    if args.solve:
        if args.baseline:
            bdir = out_dir / "solve_baseline_src"
            bdir.mkdir(parents=True, exist_ok=True)
            patches = split_patch(SOLVE_PATCH.read_text())
            for f in args.baseline.iterdir():
                if f.suffix in (".cu", ".cuh"):
                    text = f.read_text()
                    if f.name in patches:
                        text = apply_patch(text, patches[f.name])
                    (bdir / f.name).write_text(text)
            report_solve("baseline solve (b34c8df with pr7_solve_stamps.patch)", bdir,
                         out_dir / "solve_baseline", True, cyc_per_us)
        if not args.only_baseline:
            report_solve("piccolax_torch/csrc solve", CSRC, out_dir / "solve_current", False,
                         cyc_per_us)
        print(card, flush=True)
        return 0
    todo = []
    if args.baseline:
        bdir = out_dir / "baseline_src"
        bdir.mkdir(parents=True, exist_ok=True)
        patches = split_patch(BASELINE_PATCH.read_text())
        for f in args.baseline.iterdir():
            if f.suffix in (".cu", ".cuh"):
                text = f.read_text()
                if f.name in patches:
                    text = apply_patch(text, patches[f.name])
                (bdir / f.name).write_text(text)
        todo.append(("baseline (1f359b2 with pr6_stamps.patch)", bdir, out_dir / "baseline", True))
    if not args.only_baseline:
        todo.append(("piccolax_torch/csrc", CSRC, out_dir / "current", False))
    for name, src, out, base in todo:
        t0 = time.perf_counter()
        libs = build_all(src, out)
        print(f"== {name}: built in {time.perf_counter() - t0:.1f} s", flush=True)
        report(name, libs, base, cyc_per_us)
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True,
                            text=True).stdout.strip()
    print(f"SM clock now, max: {clocks}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
