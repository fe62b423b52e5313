"""Build, load and count the port's CUDA kernels.

Each `csrc/*.cu` source compiles with nvcc for sm_90a into its own shared
library with a plain C interface, bound with ctypes. The build runs at
first use, all sources at once, into `piccolax_torch/_build/<hash>/`, keyed
by a hash of the sources and flags, and raises if nvcc fails. Nothing is
built or loaded when the module is imported.

`LAUNCHES` counts, per kernel, the launches its wrapper made: a wrapper
adds one where it launches its kernel and nowhere else (one for each call
of the K3 factor and the K9 wrappers, whose C entries launch a sequence of
kernels: a factor one or two a level, a K9 solve three). K4's and K6's
derivative form counts under its own keys ("expm_taylor_fixed_derivatives",
"expm_pade_fixed_derivatives"). `WIDTHS` counts the launches of K4 and K6
in both forms by block width ("expm_taylor_fixed 8",
"expm_taylor_fixed_derivatives 4"), which tells a path's residual sweeps
from its derivative launches and from dense augmentations.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "WIDTHS", "COLUMNS", "reset_launch_counts", "count_launch",
           "count_solve", "load",
           "build", "check", "stream_handle", "is_f64", "require"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "_build"
_SOURCES = ("chol_inv", "psd_clamp", "condensed_cr", "cr_solve", "expm_fixed",
            "expm_pade13", "qd", "tri_inv", "knot")
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
          "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES = {"chol_inv_factor": 0, "psd_clamp": 0, "condensed_factor": 0,
            "condensed_solve": 0, "expm_taylor_fixed": 0,
            "expm_taylor_fixed_derivatives": 0, "expm_pade13": 0,
            "expm_pade_fixed": 0, "expm_pade_fixed_derivatives": 0,
            "qd_factor": 0, "qd_solve": 0,
            "tri_lower_inv": 0, "knot_factor": 0, "knot_solve": 0,
            "knot_tridiag_solve": 0}

WIDTHS: dict = {}
COLUMNS: dict = {}

_LIBS: dict = {}

_C = ctypes.c_int
_P = ctypes.c_void_p
_L = ctypes.c_longlong
_D = ctypes.c_double
_SIGNATURES = {
    "chol_inv": {"px_chol_inv_factor": ([_C, _P, _P, _L, _C, _P], _C)},
    "psd_clamp": {"px_psd_clamp": ([_C, _P, _P, _L, _C, _C, _C, _D, _P], _C)},
    "condensed_cr": {
        "px_cr_factor": ([_C, _P, _P, _P, _P, _P, _P, _C, _C, _C, _C, _C, _P], _C),
        "px_cr_factor_ws": ([_C, _C, _C, _C], _L),
    },
    "cr_solve": {
        "px_condensed_solve": ([_C, _P, _P, _P, _P, _P, _P, _P, _C, _C, _C, _C,
                                _C, _C, _P], _C),
        "px_condensed_solve_ws": ([_C, _C, _C, _C, _C], _L),
        "px_condensed_solve_cluster": ([_C] * 5, _C),
    },
    "expm_fixed": {
        "px_expm_taylor": ([_C, _P, _P, _L, _C, _C, _C, _P], _C),
        "px_expm_pade_fixed": ([_C, _P, _P, _L, _C, _C, _C, _P], _C),
        "px_expm_fixed_derivatives": ([_C] * 4 + [_P] * 5 + [_L, _L, _C, _C, _P], _C),
    },
    "expm_pade13": {"px_expm_pade13": ([_C, _P, _P, _P, _L, _C, _C, _P], _C)},
    "qd": {
        "px_qd_factor": ([_C, _P, _P, _P, _P, _P, _P, _C, _C, _C, _C, _P], _C),
        "px_qd_solve": ([_C, _P, _P, _P, _P, _P, _P, _C, _C, _C, _C, _C, _P], _C),
        "px_qd_max_width": ([_C], _C),
    },
    "tri_inv": {"px_tri_lower_inv": ([_C, _P, _P, _L, _C, _P], _C)},
    "knot": {
        "px_knot_factor_ws": ([_C] * 5, _L),
        "px_knot_solve_ws": ([_C] * 6, _L),
        "px_knot_factor": ([_C] + [_P] * 9 + [_C] * 5 + [_P], _C),
        "px_knot_solve": ([_C] + [_P] * 10 + [_C] * 6 + [_P], _C),
        "px_knot_tridiag_solve": ([_C] + [_P] * 10 + [_C] * 5 + [_P], _C),
        "px_knot_solve_cluster": ([_C] * 8, _C),
    },
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    WIDTHS.clear()
    COLUMNS.clear()


def count_solve(name: str, r: int) -> None:
    """One launch of KKT solve `name` on r right-hand-side columns."""
    LAUNCHES[name] += 1
    key = f"{name} r{r}"
    COLUMNS[key] = COLUMNS.get(key, 0) + 1


def count_launch(name: str, width: int) -> None:
    """One launch of kernel `name` on blocks `width` wide (K4, K6, both
    forms)."""
    LAUNCHES[name] += 1
    key = f"{name} {width}"
    WIDTHS[key] = WIDTHS.get(key, 0) + 1


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _build_dir() -> Path:
    h = hashlib.sha256()
    for f in sorted(_CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD / h.hexdigest()[:16]


def build() -> Path:
    """Compile every missing kernel library, one nvcc per source, all
    started together. Returns the build directory."""
    out = _build_dir()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in _SOURCES:
        lib = out / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
               str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    errors = []
    for name, (p, tmp, lib) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{name}.cu:\n{log}")
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return out


def load(name: str):
    """The ctypes library of source `name`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        out = build()
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def is_f64(t: torch.Tensor) -> int:
    return int(t.dtype == torch.float64)


def require(t: torch.Tensor, name: str, shape=None, like=None) -> None:
    """Checks every kernel wrapper makes on an input before passing its
    pointer: a float32/float64 contiguous CUDA tensor of the given shape,
    on the device and of the dtype of `like`."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensor expected, got {t.device}")
    if like is not None and (t.device != like.device or t.dtype != like.dtype):
        raise ValueError(f"{name}: {t.dtype} on {t.device} does not match "
                         f"{like.dtype} on {like.device}")
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32 or float64 expected, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: contiguous tensor expected")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(shape)} expected, got "
                         f"{tuple(t.shape)}")
