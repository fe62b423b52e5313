"""piccolax_torch — the PyTorch/CUDA port of piccolax for one NVIDIA H100.

The same batched interior-point collocation solver as `piccolax`, written
with PyTorch tensors and an explicit batch dimension. Every routine that
`piccolax` shaped for the TPU (the Cholesky-inverse factor, the
Newton-Schulz PSD clamp, the cyclic-reduction and the sequential
quasidefinite KKT, the lower-triangular inverse, the Taylor and the
fixed-order Pade expm of the collocation residuals, the Pade-13 expm of
the rollouts) is a hand-written CUDA kernel for sm_90a here (`csrc/`),
with a plain PyTorch version beside it that serves tensors on the CPU.

Entry points run on the card unless the caller passes `device="cpu"`.

Precision: float32 matrix products run in full float32 (no TF32), the
twin of the MXU precision guard in `piccolax.solver.ipm._trace_ctx`.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

from . import control, parallel, quantum, solver, utils  # noqa: E402
from .benchmarks import (cnot_problem, lindblad_problem,  # noqa: E402
                         qutrit_x_problem, robustness_ensemble, sx_gate_problem)
from .control import QuantumControlProblem, SmoothPulseProblem, build_nlp  # noqa: E402
from .convert import nlp_from_numpy  # noqa: E402
from .ops.expm import expm  # noqa: E402
from .parallel.mesh import batch_solve  # noqa: E402
from .quantum.dynamics import (density_fidelity, density_rollout,  # noqa: E402
                               unitary_fidelity, unitary_rollout,
                               unitary_rollout_fidelity)
from .quantum.gates import GATES, PAULIS  # noqa: E402
from .quantum.operators import EmbeddedOperator  # noqa: E402
from .quantum.pulses import ZeroOrderPulse  # noqa: E402
from .quantum.systems import (LinearDissipator, OpenQuantumSystem,  # noqa: E402
                              QuantumSystem)
from .quantum.templates import TransmonSystem  # noqa: E402
from .quantum.trajectories import (DensityTrajectory, UnitaryTrajectory,  # noqa: E402
                                   discretize, extract_pulse)
from .solver import IPMOptions, IPMState, solve_nlp, solve_nlp_traced  # noqa: E402
from .trajectory import KnotLayout, Trajectory  # noqa: E402

__all__ = [
    "GATES", "PAULIS", "DensityTrajectory", "EmbeddedOperator", "IPMOptions",
    "IPMState", "KnotLayout", "LinearDissipator", "OpenQuantumSystem",
    "QuantumControlProblem", "QuantumSystem", "SmoothPulseProblem",
    "Trajectory", "TransmonSystem", "UnitaryTrajectory", "ZeroOrderPulse",
    "batch_solve", "build_nlp", "discretize", "expm", "extract_pulse",
    "nlp_from_numpy", "solve_nlp", "solve_nlp_traced", "cnot_problem", "lindblad_problem",
    "qutrit_x_problem", "robustness_ensemble", "sx_gate_problem",
    "density_fidelity", "density_rollout", "unitary_fidelity",
    "unitary_rollout", "unitary_rollout_fidelity",
]
