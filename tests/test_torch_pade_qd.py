"""The solver on kkt_backend="qd" with the Pade integrator
(SmoothPulseProblem(pade_order=7)) against piccolax, on the reduced
quickstart (N = 18, T = 3, free timesteps) on the CPU in float64: the
first iterates of a batch of two and solve -> fidelity end to end.

One module fixture runs both sides once: piccolax's build and its IPM (a
while_loop, one compile, run on each problem of the batch) in a worker
thread, the port's batched first iterates and solve in this one. XLA
compiles without the GIL, so most of piccolax's compile time overlaps
the port's work."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import piccolax as px  # noqa: E402
from piccolax.control import problem as jproblem  # noqa: E402
from piccolax.solver import ipm as jipm  # noqa: E402
import piccolax_torch as pt  # noqa: E402
from piccolax_torch import _kernels  # noqa: E402
from piccolax_torch.solver import ipm as pipm  # noqa: E402

N, T, NB = 18, 3.0, 2
OPTS = dict(max_iter=150, tol=1e-7, constr_viol_tol=1e-7, kkt_backend="qd")
N_FIRST = 5
_HIST = ("Z", "lam", "mu", "delta_used")


def _quickstart(mod, **kw):
    sysm = mod.QuantumSystem(0.5 * mod.PAULIS["Z"],
                             [mod.PAULIS["X"], mod.PAULIS["Y"]], 1.0)
    times = np.linspace(0.0, T, N)
    pulse = mod.ZeroOrderPulse(
        0.1 * np.random.default_rng(0).standard_normal((N, 2)), times)
    qtraj = mod.UnitaryTrajectory(sysm, pulse, mod.GATES["X"], **kw)
    return sysm, mod.SmoothPulseProblem(qtraj, N, Q=100.0, R=1e-2, ddu_bound=1.0,
                                        dt_bounds=(0.05, 0.2), pade_order=7)


def _jax_side(Zb):
    """piccolax's Pade build and its IPM with kkt_backend "qd" on each
    problem of the batch as a while_loop, keeping the first N_FIRST
    iterates: (problem, layout, history {name: [NB, N_FIRST, ...]}, final
    state of problem 0)."""
    _, jqcp = _quickstart(px)
    jnlp, jparams, _, _, jlay = jqcp.build()
    opts = jipm.IPMOptions(**OPTS)

    def run(Z0):
        st, body = jipm._setup(jnlp, jparams, Z0, None, opts)
        hist = {k: jnp.zeros((N_FIRST,) + jnp.shape(getattr(st, k)),
                             jnp.result_type(getattr(st, k))) for k in _HIST}

        def cond(c):
            s = c[0]
            return (s.it < opts.max_iter) & ~(s.converged | s.stalled)

        def step(c):
            s, h = c
            s = body(s)
            slot = jnp.minimum(s.it - 1, N_FIRST - 1)
            h = {k: jnp.where(s.it <= N_FIRST, h[k].at[slot].set(getattr(s, k)),
                              h[k]) for k in _HIST}
            return s, h

        return jax.lax.while_loop(cond, step, (st, hist))[::-1]

    run = jax.jit(run)
    out = [run(jnp.asarray(Z0)) for Z0 in Zb]
    hist = {k: np.stack([np.asarray(h[k]) for h, _ in out]) for k in _HIST}
    return jqcp, jlay, hist, out[0][1]


@pytest.fixture(scope="module")
def runs():
    """Both sides from one batch: the quickstart's start Z0 and Z0 with its
    pulse perturbed by 0.02 N(0, 1). The port's side: the first N_FIRST
    iterates of the batch, then qcp.solve of the quickstart itself."""
    psys, qcp = _quickstart(pt, device="cpu")
    nlp, params, Z0, _, lay = qcp.build(device="cpu")
    Zb = np.repeat(Z0.numpy()[None], NB, 0)
    u = lay.slices["u"]
    Zb[1, :, u] += 0.02 * np.random.default_rng(7).standard_normal(
        (N, u.stop - u.start))
    with ThreadPoolExecutor(1) as pool:
        jax_side = pool.submit(_jax_side, Zb)
        state, body = pipm._setup(nlp, params, torch.as_tensor(Zb), None,
                                  pipm.IPMOptions(**OPTS))
        first = []
        for _ in range(N_FIRST):
            state = body(state)
            first.append({k: getattr(state, k).numpy().copy() for k in _HIST})
        _kernels.reset_launch_counts()
        qcp.solve(verbose=False, device="cpu", options=pt.IPMOptions(**OPTS))
        launches = dict(_kernels.LAUNCHES)
        jqcp, jlay, hist, final = jax_side.result()
    return dict(psys=psys, qcp=qcp, first=first, launches=launches, jqcp=jqcp,
                jlay=jlay, hist=hist, final=final)


def test_qd_pade_first_iterates_match_jax(runs):
    """B = 2, newton_dir at its float64 default on both sides: the first
    iterations' Z, lam and mu to 1e-8 relative and the same candidate
    picked (delta_used) at every iteration."""
    hist = runs["hist"]
    codes = set()
    for it, got in enumerate(runs["first"]):
        for name in ("Z", "lam", "mu"):
            a, b = got[name], hist[name][:, it]
            assert np.max(np.abs(a - b)) <= 1e-8 * max(np.abs(b).max(), 1e-300), \
                (it, name)
        assert np.array_equal(got["delta_used"], hist["delta_used"][:, it]), it
        codes |= set(got["delta_used"].tolist())
    assert any(c % 100 >= 10 for c in codes)      # Newton factored at least once


def test_qd_pade_solve_matches_jax(runs):
    """qcp.solve(options=IPMOptions(kkt_backend="qd")) -> fidelity() to
    1e-6 of piccolax's (problem 0 of the reference, written back and
    synced), equal converged and stalled flags, the quickstart's own
    rollout bar, and no launch on the CPU."""
    final = runs["final"]
    jq = runs["jqcp"]
    jq.result = final
    jq.traj = jproblem._writeback(jq.traj, runs["jlay"], final.Z, final.g)
    jq.sync_trajectory()
    q = runs["qcp"]
    assert all(v == 0 for v in runs["launches"].values())
    assert q.converged == jq.converged
    assert q.stalled == jq.stalled
    F, F_ref = float(q.fidelity()), float(jq.fidelity())
    assert abs(F - F_ref) < 1e-6
    assert F > 0.99
    F_roll = float(pt.unitary_rollout_fidelity(
        runs["psys"], q.traj["u"], q.traj.get_times(), pt.GATES["X"],
        interpolation="constant", device="cpu"))
    assert abs(F - F_roll) < 1e-5
