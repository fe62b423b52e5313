"""Numerical kernels of the port. (The module `expm` keeps its name here:
the Pade-13 function `expm` is exported at the top level.)"""

from .expm import (TAYLOR_THETA, expm_action, expm_fixed, expm_pade_fixed,
                   expm_taylor_fixed)

__all__ = ["TAYLOR_THETA", "expm_action", "expm_fixed", "expm_pade_fixed",
           "expm_taylor_fixed"]
