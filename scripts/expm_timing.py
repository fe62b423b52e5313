#!/usr/bin/env python3
"""K4 and K6 (the fixed-order Taylor and Pade expm) on the card: SASS
counts, registers and CUDA-event times at every shape the solve paths
launch, against an earlier build of the same kernels.

Builds the expm sources of piccolax_torch/csrc (one `expm_fixed.cu`, or the
older pair `expm_taylor.cu` and `expm_pade_fixed.cu`) with nvcc -Xptxas -v
into piccolax_torch/_build/expm_timing/, prints each kernel's registers,
spills and stack frame, and counts in `cuobjdump -sass` each kernel's
shared-memory loads (LDS*), multiply-adds (FFMA, DFMA), barriers (BAR) and
warp barriers (WARPSYNC), over the whole function and in its hottest loop
(the loop between a backward branch and its target that holds the most
multiply-adds). Then at the paths' shapes it times (CUDA events, the least
of two runs of `--reps` launches):

- the value launches: each path's residual and line-search sweep (4 x 4 and
  8 x 8 generators, the path's order and squaring count), beside the plain
  version, torch.linalg.matrix_exp, and a device copy of the same bytes
  (`clone`), what moving them costs at that size;
- the derivative launches: r(A) and its first and second derivatives along
  d directions, A [B, N-1, w, w], as the dense path computes them (the
  3w x 3w augmentation M of `derivative_augmentations`, the value kernel on
  it, the slicing after it: "dense path"; the value kernel on M alone:
  "dense kernel") and, where the build has it, as the structured kernel
  `px_expm_fixed_derivatives` does in one launch ("structured"), with the
  largest difference between the two over the largest entry;

and, with --profile, the device time of the dense path by kernel
(torch.profiler) at qs256's and config 3's derivative shapes: the fills and
copies of the augmentation and of the slicing beside the value kernel.

Run from the root of a checkout on a machine with the card:

    python3 scripts/expm_timing.py --profile
    mkdir -p .chipcheck/pr8 && git archive 7f95e32 piccolax_torch/csrc | tar -x -C .chipcheck/pr8
    python3 scripts/expm_timing.py --baseline .chipcheck/pr8/piccolax_torch/csrc

--baseline DIR builds that directory's expm sources too and times both
builds in one process, in turns (baseline, current, current, baseline), so
that the two are compared on one card.
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
OPS = ("LDS", "FFMA", "DFMA", "DMMA", "BAR", "WARPSYNC", "SHFL")
H100_FLOPS = 67e12          # float32 outside the tensor cores; float64 on DMMA
H100_BYTES_PER_S = 3.35e12

# The solve paths' expm launches (chip_smoke.py's paths): the residual
# [B, N-1, w, w], the line-search sweep [B x directions x ls_iters, N-1, w, w]
# and the derivative launch at [B, N-1] knots, w wide, d directions. order:
# "taylor" (8 in float32, 12 in float64) or a Pade order; s: the
# integrator's squaring count.
# (path, B, N-1, w, d, dtype, order, s, sweep candidates)
PATHS = [
    ("c1", 256, 49, 4, 2, "float32", "taylor", 0, 2 * 6),
    ("qs", 1, 99, 4, 3, "float64", "taylor", 1, 3 * 8),
    ("qs256", 256, 99, 4, 3, "float64", "taylor", 1, 3 * 8),
    ("pq", 1, 99, 4, 3, "float64", 7, 0, 3 * 8),
    ("pq256", 256, 99, 4, 3, "float64", 7, 0, 3 * 8),
    ("c3", 16, 199, 8, 4, "float32", "taylor", 2, 2 * 8),
    ("CNOT", 1, 199, 8, 4, "float64", "taylor", 2, 3 * 8),
]


def tool(name: str) -> str:
    found = subprocess.run(["which", name], capture_output=True, text=True).stdout.strip()
    return found or f"/usr/local/cuda/bin/{name}"


def sources(src_dir: Path) -> list[str]:
    if (src_dir / "expm_fixed.cu").exists():
        return ["expm_fixed"]
    return ["expm_taylor", "expm_pade_fixed"]


def build(src_dir: Path, name: str, out: Path) -> str:
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(src_dir),
           "-o", str(out), str(src_dir / f"{name}.cu")]
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


def sass_counts(so: Path) -> list[tuple[str, dict, int, dict]]:
    """(function, whole-function counts, hottest loop length, its counts)."""
    text = subprocess.run([tool("cuobjdump"), "-sass", str(so)], capture_output=True,
                          text=True).stdout
    out = []
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name = block.splitlines()[0].strip()
        ins = []
        for line in block.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)",
                         line)
            if m:
                ins.append((int(m.group(1), 16), m.group(2), m.group(3)))

        def counts(seg):
            c = {op: sum(1 for _, o, _ in seg if o.startswith(op)) for op in OPS}
            c["all"] = len(seg)
            return c

        best = None
        for addr, op, rest in ins:
            t = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
            if t and int(t.group(1), 16) < addr:
                seg = [x for x in ins if int(t.group(1), 16) <= x[0] <= addr]
                c = counts(seg)
                key = c["FFMA"] + c["DFMA"]
                if best is None or key > best[0]:
                    best = (key, len(seg), c)
        out.append((name, counts(ins), best[1] if best else 0, best[2] if best else {}))
    return out


class Build:
    """The ctypes entries of one build of the expm sources."""

    def __init__(self, label: str, src_dir: Path):
        I_, P_, L_ = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
        self.label = label
        self.value = {}
        self.structured = None
        out_dir = ROOT / "piccolax_torch" / "_build" / "expm_timing" / label
        for name in sources(src_dir):
            t0 = time.perf_counter()
            so = out_dir / f"lib{name}.so"
            log = build(src_dir, name, so)
            print(f"== {label} {name}.cu ({src_dir}): built in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            for line in ptxas_lines(log):
                print(f"  ptxas {line}", flush=True)
            for fn, whole, n, loop in sass_counts(so):
                ratio = whole["LDS"] / max(1, whole["FFMA"] + whole["DFMA"])
                print(f"  sass {fn}: whole " + ", ".join(f"{k} {v}" for k, v in whole.items())
                      + f" (LDS per multiply-add {ratio:.3f}); hottest loop "
                      + (f"{n} instructions: " + ", ".join(f"{k} {v}" for k, v in loop.items())
                         if n else "none"), flush=True)
            lib = ctypes.CDLL(str(so))
            for fn in ("px_expm_taylor", "px_expm_pade_fixed"):
                if hasattr(lib, fn):
                    f = getattr(lib, fn)
                    f.argtypes = [I_, P_, P_, L_, I_, I_, I_, P_]
                    f.restype = I_
                    self.value["taylor" if fn == "px_expm_taylor" else "pade"] = f
            if hasattr(lib, "px_expm_fixed_derivatives"):
                f = lib.px_expm_fixed_derivatives
                f.argtypes = [I_, I_, I_, I_, P_, P_, P_, P_, P_, L_, L_, I_, I_, P_]
                f.restype = I_
                self.structured = f

    def expm(self, A, order, s):
        import torch
        out = torch.empty_like(A)
        n = A.shape[-1]
        f = self.value["taylor" if order == "taylor" else "pade"]
        o = (12 if A.dtype == torch.float64 else 8) if order == "taylor" else order
        rc = f(int(A.dtype == torch.float64), A.data_ptr(), out.data_ptr(),
               A.numel() // (n * n), n, o, s, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{self.label}: expm launch failed ({rc})")
        return out

    def dense_path(self, A, E, order, s):
        """The dense derivative path: augmentation, value kernel, slicing."""
        import torch
        from piccolax_torch.ops.expm import derivative_augmentations
        w, d = A.shape[-1], E.shape[-3]
        lead = A.shape[:-2]
        R = self.expm(derivative_augmentations(A, E), order, s).reshape(
            *lead, d, d, 3 * w, 3 * w)
        idx = torch.arange(d, device=A.device)
        half = R[..., :w, 2 * w:]
        return (R[..., 0, 0, :w, :w], R[..., idx, idx, :w, w:2 * w],
                half + half.transpose(-3, -4))

    def structured_path(self, A, E, order, s):
        import torch
        w, d = A.shape[-1], E.shape[-3]
        f64 = A.dtype == torch.float64
        Phi = torch.empty_like(A)
        dPhi = torch.empty_like(E)
        D2 = A.new_empty(*A.shape[:-2], d, d, w, w)
        o = (12 if f64 else 8) if order == "taylor" else order
        rc = self.structured(int(f64), int(order == "taylor"), o, s, A.data_ptr(),
                             E.data_ptr(), Phi.data_ptr(), dPhi.data_ptr(), D2.data_ptr(),
                             A.numel() // (w * w), E.numel() // (d * w * w), w, d,
                             torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{self.label}: structured launch failed ({rc})")
        return Phi, dPhi, D2


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


def inputs(rng, lead, w, d, dtype, order, s):
    """A [*lead, w, w] and E [*lead, d, w, w] on the card, A's inf-norm half
    the order's accuracy radius times 2^s, E a tenth of it."""
    import torch
    from piccolax_torch.ops.expm import TAYLOR_THETA, pade_radius
    radius = TAYLOR_THETA if order == "taylor" else pade_radius(order)
    A = rng.standard_normal((*lead, w, w))
    A *= 0.5 * radius * 2.0 ** s / np.abs(A).sum(-1).max(-1)[..., None, None]
    E = 0.1 * radius * 2.0 ** s * rng.standard_normal((*lead, d, w, w)) / w
    t = lambda x: torch.as_tensor(x, dtype=getattr(torch, dtype), device="cuda")  # noqa: E731
    return t(A), t(E)


def device_us(event):
    """A profiler average's device time in us (named cuda_time_total in
    older PyTorch)."""
    t = getattr(event, "device_time_total", None)
    return t if t is not None else getattr(event, "cuda_time_total", 0)


def rel(a, b):
    return ((a.double() - b.double()).abs().max() / b.double().abs().max()).item()


def in_turns(builds, fn, reps):
    """{build label: least ms of two runs}, in the order a, b, b, a."""
    order = list(builds) + list(builds)[::-1]
    times = {b.label: [] for b in builds}
    for b in order:
        times[b.label].append(time_ms(lambda: fn(b), reps))
    return {k: min(v) for k, v in times.items()}


def structured_bound(M, w, d, es, order, s, taylor_order):
    """Least time of the derivative launch on the card: bytes of A, E, Phi,
    dPhi and D2 once, and the multiply-adds of the structured algebra (the
    D, F and symmetric S chains: 1 + 2d + 4 d(d+1)/2 w x w products a step),
    over the peaks."""
    if order == "taylor":
        steps = (4 if taylor_order == 8 else 5) + s
    else:
        steps = (order - 1) // 2 + 14 + s
    flops = 2 * M * steps * (1 + 2 * d + 2 * d * (d + 1)) * w ** 3
    nbytes = M * es * w * w * (1 + d + 1 + d + d * d)
    return 1e3 * max(flops / H100_FLOPS, nbytes / H100_BYTES_PER_S)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, help="a directory holding an earlier "
                    "piccolax_torch/csrc, timed beside this checkout's")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--profile", action="store_true", help="also profile the dense "
                    "derivative path at qs256's and config 3's shapes")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("expm_timing: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    builds = ([Build("baseline", args.baseline)] if args.baseline else []) \
        + [Build("current", CSRC)]
    rng = np.random.default_rng(9)

    from piccolax_torch.ops.expm import expm_fixed_plain
    print("== value launches (residual and line-search sweep)", flush=True)
    for path, B, K, w, d, dtype, order, s, cand in PATHS:
        es = 8 if dtype == "float64" else 4
        for what, lead in (("residual", (B, K)), ("sweep", (B * cand, K))):
            A, _ = inputs(rng, lead, w, 0, dtype, order, s)
            ref = builds[0].expm(A, order, s)
            errs = {b.label: rel(b.expm(A, order, s), ref) for b in builds}
            ms = in_turns(builds, lambda b: b.expm(A, order, s), args.reps)
            copy = time_ms(lambda: A.clone(), args.reps)
            plain = time_ms(lambda: expm_fixed_plain(A, order, s), args.reps)
            lib = time_ms(lambda: torch.linalg.matrix_exp(A), args.reps)
            M = A.numel() // (w * w)
            bound = 1e3 * 2 * M * w * w * es / H100_BYTES_PER_S
            print(f"{path} {what} {list(A.shape)} {dtype} order {order} s={s}: "
                  + "; ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
                  + f"; plain version {plain:.4f} ms, matrix_exp {lib:.4f} ms"
                  + f"; bytes bound {bound:.4f} ms, a copy of A (clone) {copy:.4f} ms; "
                  f"rel diff vs {builds[0].label} "
                  + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()), flush=True)

    print("== derivative launches", flush=True)
    for path, B, K, w, d, dtype, order, s, _ in PATHS:
        es = 8 if dtype == "float64" else 4
        A, E = inputs(rng, (B, K), w, d, dtype, order, s)
        from piccolax_torch.ops.expm import derivative_augmentations
        Maug = derivative_augmentations(A, E)
        ref = builds[0].dense_path(A, E, order, s)
        line = []
        for b in builds:
            kern = in_turns([b], lambda bb: bb.expm(Maug, order, s), args.reps)[b.label]
            full = in_turns([b], lambda bb: bb.dense_path(A, E, order, s), args.reps)[b.label]
            part = f"{b.label}: dense kernel {kern:.4f} ms, dense path {full:.4f} ms"
            if b.structured is not None:
                got = b.structured_path(A, E, order, s)
                errs = [rel(g, r) for g, r in zip(got, ref)]
                st = in_turns([b], lambda bb: bb.structured_path(A, E, order, s),
                              args.reps)[b.label]
                part += (f", structured {st:.4f} ms (rel diff vs {builds[0].label}'s dense "
                         f"path: Phi {errs[0]:.1e}, dPhi {errs[1]:.1e}, D2 {errs[2]:.1e})")
            line.append(part)
        lib = time_ms(lambda: torch.linalg.matrix_exp(Maug), args.reps)
        torder = 12 if dtype == "float64" else 8
        bound = structured_bound(B * K, w, d, es, order, s, torder)
        print(f"{path} derivatives [{B},{K}] w={w} d={d} {dtype} order {order} s={s} "
              f"(augmentation {list(Maug.shape)}): " + "; ".join(line)
              + f"; matrix_exp on M {lib:.4f} ms; structured bound {bound:.4f} ms",
              flush=True)

    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        b = builds[-1]
        for path, B, K, w, d, dtype, order, s, _ in PATHS:
            if path not in ("qs256", "c3"):
                continue
            A, E = inputs(rng, (B, K), w, d, dtype, order, s)
            b.dense_path(A, E, order, s)
            torch.cuda.synchronize()
            reps = 5
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    b.dense_path(A, E, order, s)
                torch.cuda.synchronize()
            rows = sorted(((e.key, device_us(e) / reps / 1e3, e.count // reps)
                           for e in prof.key_averages() if device_us(e) > 0),
                          key=lambda r: -r[1])
            total = sum(r[1] for r in rows)
            expm = sum(r[1] for r in rows if "expm" in r[0])
            print(f"profile {path} dense derivative path ({b.label}): {total:.4f} ms of "
                  f"device time a call, the value kernel {expm:.4f}, the augmentation's "
                  f"and slicing's kernels {total - expm:.4f} ({len(rows)} kinds):",
                  flush=True)
            for key, ms, n in rows:
                print(f"  {ms:.4f} ms  x{n}  {key[:110]}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
