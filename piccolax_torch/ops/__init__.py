"""Numerical kernels of the port."""

from .expm import TAYLOR_THETA, expm_fixed, expm_taylor_fixed

__all__ = ["TAYLOR_THETA", "expm_fixed", "expm_taylor_fixed"]
