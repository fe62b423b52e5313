#!/usr/bin/env python3
"""Host work of one IPM iteration: the aten operators `torch.profiler`
records (all, and those called from Python, each a dispatch and, on the
card, about a launch) per iteration of config 1's body (SX gate, N = 50,
float32, config 1's options) on the CPU, for the package in the tree
given (default: this checkout). A tree without globals runs fewer
operators only if it skips their work.

    python3 scripts/op_count.py [TREE]
"""

from __future__ import annotations

import os
import sys


def main():
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
    sys.path.insert(0, tree)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import piccolax_torch as pt
    from piccolax_torch.solver import ipm
    assert os.path.abspath(pt.__file__).startswith(tree), pt.__file__
    torch.set_num_threads(2)
    nlp, params, Z0, _, _ = pt.sx_gate_problem(N=50, T=10.0, device="cpu").build(
        device="cpu")
    nlp = nlp.to("cpu", torch.float32)
    params = pt.solver.nlp.params_to(params, "cpu", torch.float32)
    opts = pt.IPMOptions(max_iter=60, tol=5e-3, constr_viol_tol=5e-3, ls_iters=6,
                         clamp_iters=15)
    state, body = ipm._setup(nlp, params, Z0.float().expand(4, -1, -1).contiguous(),
                             None, opts)
    state = body(state)
    n = 3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            state = body(state)
    aten = [e for e in prof.events() if e.name.startswith("aten::")]
    top = [e for e in aten if e.cpu_parent is None]
    print(f"{tree}: aten operators an iteration {len(aten) / n:.1f}, called from "
          f"Python {len(top) / n:.1f}", flush=True)


if __name__ == "__main__":
    main()
