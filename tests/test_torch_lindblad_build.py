"""Config 5 (the Lindblad density transfer |0><0| -> |1><1| on a 3-level
transmon with decay) in the port against piccolax, on the CPU in float64
at N = 11, T = 2 (two squarings, as at N = 50, T = 10): the build (Z0
from the density rollout, not a geodesic; dz = 15, m = 13), the cost and
residuals, the density integrator's Jacobian blocks and Hessian (against
`torch.func` autodiff of the port's own residual and against piccolax),
the first IPM iterates, a full solve, and `convert.nlp_from_numpy` from
piccolax's arrays. One JAX build, shared by the file; at most 9 tests
(pytest-xdist's loadfile schedule hands out files with more tests
first). The building blocks are held in tests/test_torch_lindblad.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from piccolax import benchmarks as jbm  # noqa: E402
from piccolax.solver import ipm as jipm  # noqa: E402
from piccolax.solver.nlp import nlp_constraint_residuals as jres  # noqa: E402
from piccolax.solver.nlp import nlp_total_cost as jcost  # noqa: E402
import piccolax_torch as pt  # noqa: E402
from piccolax_torch import _kernels  # noqa: E402
from piccolax_torch.control import integrators as pintg  # noqa: E402
from piccolax_torch.convert import nlp_from_numpy  # noqa: E402
from piccolax_torch.quantum import isomorphisms as piso  # noqa: E402
from piccolax_torch.solver import ipm as pipm  # noqa: E402

N, T, M, DZ = 11, 2.0, 13, 15


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.fixture(scope="module")
def built():
    jprob = jbm.lindblad_problem(N=N, T=T)
    jnlp, jparams, jZ0, jg0, jlay = jprob.build()
    prob = pt.lindblad_problem(N=N, T=T, device="cpu")
    nlp, params, Z0, _, lay = prob.build(device="cpu")
    return dict(jprob=jprob, jnlp=jnlp, jparams=jparams, jZ0=np.asarray(jZ0),
                jg0=jg0, jlay=jlay, prob=prob, nlp=nlp, params=params, Z0=Z0,
                lay=lay)


def test_lindblad_build_matches_jax(built):
    """Layout rho 0:9, u 9:11, du 11:13, ddu 13:15, m = 13; Z0's states are
    the density rollout of the seed pulse (no geodesic), within the +-1
    box; bounds, pins and the compact goal |1><1| to 1e-12; two squarings,
    Taylor; the density integrator and objective; the trajectory's own
    fidelity."""
    p = built
    assert p["lay"].slices == p["jlay"].slices
    assert p["nlp"].m == M and p["Z0"].shape == (N, DZ)
    assert np.max(np.abs(p["Z0"].numpy() - p["jZ0"])) < 1e-12
    qt = p["prob"].qtraj
    assert isinstance(qt, pt.DensityTrajectory)
    rho = p["lay"].slices["rho"]
    rhos = piso.density_to_compact_iso(qt.rhos.numpy())
    assert np.max(np.abs(p["Z0"].numpy()[:, rho] - rhos)) < 1e-15
    assert np.all(p["nlp"].hi.numpy()[1:, rho] == 1.0)
    for key in ("lo", "hi", "pin_mask"):
        a, b = getattr(p["nlp"], key).numpy(), np.asarray(getattr(p["jnlp"], key))
        assert np.array_equal(np.isfinite(a), np.isfinite(b))
        fin = np.isfinite(b)
        assert np.max(np.abs(a[fin] - b[fin]), initial=0.0) < 1e-12
    assert np.max(np.abs(p["params"]["pin_val"].numpy()
                         - np.asarray(p["jparams"]["pin_val"]))) < 1e-12
    goal = p["params"]["goal"]["rho"].numpy()
    assert np.array_equal(goal, np.asarray(p["jparams"]["goal"]["rho"]))
    assert np.array_equal(goal, np.eye(9)[2])
    intg, jintg = p["prob"].integrators[0], p["jprob"].integrators[0]
    assert isinstance(intg, pintg.BilinearDensityIntegrator)
    assert intg.state_names == jintg.state_names == ("rho",)
    assert intg.squarings == jintg.squarings == 2 and intg.order == "taylor"
    names = [type(o).__name__ for o in p["prob"].objectives]
    assert names == [type(o).__name__ for o in p["jprob"].objectives]
    assert abs(qt.fidelity().item() - float(p["jprob"].qtraj.fidelity())) < 1e-12


def test_lindblad_cost_and_derivatives_match_jax(built):
    """Residuals, cost, Cself, Cnext, the cost gradient and the
    Lagrangian Hessians at a perturbed Z0 with random multipliers: 1e-10
    relative; no kernel launched on the CPU."""
    p = built
    rng = np.random.default_rng(11)
    Z = p["jZ0"] + 0.05 * rng.standard_normal((N, DZ))
    lam = rng.standard_normal((N, M))
    c_r, f_r, (Cs_r, Cn_r), g_r, H_r = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda Zj, lj: (
            jres(p["jnlp"], Zj, p["jg0"], p["jparams"]),
            jcost(p["jnlp"], Zj, p["jg0"], p["jparams"]),
            jipm._jacobians(p["jnlp"], Zj, p["jg0"], p["jparams"])[:2],
            jipm._gradients(p["jnlp"], Zj, p["jg0"], p["jparams"])[0],
            jipm._stage_hessians_split(p["jnlp"], Zj, p["jg0"], p["jparams"], lj)))(
        jnp.asarray(Z), jnp.asarray(lam)))
    Zt = torch.as_tensor(Z)
    _kernels.reset_launch_counts()
    c = pt.solver.nlp_constraint_residuals(p["nlp"], Zt, None, p["params"])
    f = pt.solver.nlp_total_cost(p["nlp"], Zt, None, p["params"])
    g, Cs, Cn, H = pipm._derivatives(p["nlp"], Zt, p["params"], torch.as_tensor(lam))
    assert all(v == 0 for v in _kernels.LAUNCHES.values())
    assert _rel(c.numpy(), c_r) < 1e-10
    assert abs(float(f) - float(f_r)) < 1e-10 * max(1.0, abs(float(f_r)))
    assert _rel(Cs.numpy(), Cs_r) < 1e-10
    assert _rel(Cn.numpy(), Cn_r) < 1e-10
    assert _rel(g.numpy(), g_r) < 1e-10
    assert _rel(H.numpy(), H_r) < 1e-10


@pytest.mark.parametrize("dt_free", [False, True])
def test_density_integrator_derivatives_match_autodiff(built, dt_free):
    """The structured Jacobian blocks and Hessian of every integrator's
    rows (the density integrator's from one derivative-form call) against
    torch.func autodiff of the port's own residual, to 1e-10 relative:
    config 5's frozen timesteps, and free equal timesteps
    (dt_bounds=(0.1, 0.25): dt is then a direction of the expm)."""
    if dt_free:
        prob = pt.lindblad_problem(N=N, T=T, device="cpu", dt_bounds=(0.1, 0.25))
        nlp, params, Z0, _, lay = prob.build(device="cpu")
        assert "dt" in lay.slices and nlp.m == M + 1
    else:
        nlp, params, Z0 = built["nlp"], built["params"], built["Z0"]
    rng = np.random.default_rng(12 + dt_free)
    Z = Z0 + 0.05 * torch.as_tensor(rng.standard_normal(Z0.shape))
    lam = torch.as_tensor(rng.standard_normal((N - 1, nlp.md)))
    A, Bn, H = nlp.dynamics_derivatives(Z, params, lam)
    J = torch.func.jacrev(lambda X: nlp.dynamics(X, params))(Z)
    Hf = torch.func.hessian(lambda X: torch.sum(lam * nlp.dynamics(X, params)))(Z)
    k = torch.arange(N - 1)
    assert _rel(A.numpy(), J[k, :, k].numpy()) < 1e-10
    assert _rel(Bn.numpy(), J[k, :, k + 1].numpy()) < 1e-10
    assert _rel(H.numpy(), Hf[k, :, k].numpy()) < 1e-10
    assert np.abs(H.numpy()).max() > 1e-3


def test_first_iterates_match_jax(built):
    """Three IPM iterations from the build's Z0 (prob.solve's options)
    against piccolax's IPM body: Z to 1e-10 relative, lam and mu to 1e-8."""
    p = built
    opts = dict(max_iter=3, tol=1e-7, constr_viol_tol=1e-7)
    s, jbody = jipm._setup(p["jnlp"], p["jparams"], jnp.asarray(p["jZ0"]), None,
                           jipm.IPMOptions(**opts))
    jbody = jax.jit(jbody)
    state, body = pipm._setup(p["nlp"], p["params"], p["Z0"][None], None,
                              pipm.IPMOptions(**opts))
    for it in range(3):
        s = jbody(s)
        state = body(state)
        assert _rel(state.Z[0].numpy(), s.Z) < 1e-10, it
        for name in ("lam", "mu"):
            assert _rel(getattr(state, name)[0].numpy(), getattr(s, name)) < 1e-8, (it, name)


def test_lindblad_solve_matches_jax(built):
    """prob.solve(max_iter=150, tol=1e-7) to its end: piccolax's 142
    iterations and the synced trajectory's fidelity to 1e-6 (0.944804);
    the rollout of the extracted pulse re-runs the trajectory."""
    p = built
    jprob, prob = p["jprob"], pt.lindblad_problem(N=N, T=T, device="cpu")
    jprob.solve(max_iter=150, tol=1e-7, verbose=False)
    prob.solve(max_iter=150, tol=1e-7, verbose=False, device="cpu")
    assert int(prob.result.it) == int(jprob.result.it) == 142
    assert prob.converged == bool(jprob.converged)
    F, jF = prob.fidelity().item(), float(jprob.fidelity())
    assert abs(F - jF) < 1e-6 and abs(F - 0.944804) < 1e-6
    again = prob.qtraj.rollout()
    assert abs(again.fidelity().item() - F) < 1e-15


def test_nlp_from_numpy_matches_jax(built):
    """Arrays taken out of piccolax's build (its solver view's tuples
    stacked) give the port's own NLP: residuals, cost and Hessians equal
    to 1e-12."""
    p = built
    jprob, jnlp, jparams, jlay = p["jprob"], p["jnlp"], p["jparams"], p["jlay"]
    sv = jparams["system"]
    bil = jprob.integrators[0]
    regs = {o.name: o.R for o in jprob.objectives if hasattr(o, "R")}
    u = bil.drive_name
    arrays = {
        "Z0": p["jZ0"], "lo": np.asarray(jnlp.lo), "hi": np.asarray(jnlp.hi),
        "pin_mask": np.asarray(jnlp.pin_mask), "pin_val": np.asarray(jparams["pin_val"]),
        "dt": np.asarray(jparams["frozen"]["dt"])[:, 0],
        "t": np.asarray(jparams["frozen"]["t"])[:, 0],
        "G_drift": np.asarray(sv.drift_terms[0].H),
        "G_drives": np.stack([np.asarray(d.H) for d in sv.drive_terms]),
        "lind_drift": np.asarray(sv.lind_drift[0]), "lind_drives": np.stack(sv.lind_drives),
        "diss_mats": np.stack(sv.diss_mats), "diss_rates": np.stack(sv.diss_rates),
        "goal": np.asarray(jparams["goal"]["rho"]), "Q": jprob.objectives[0].Q,
        "R": [regs.get(n, 0.0) for n in (u, "d" + u, "dd" + u)],
        "slices": {n: (s.start, s.stop) for n, s in jlay.slices.items()},
        "state_name": "rho", "drive_name": u, "squarings": bil.squarings,
        "state_kind": "density",
    }
    nlp2, params2, Z02, _, lay2 = nlp_from_numpy(arrays, device="cpu")
    assert torch.max(torch.abs(Z02 - p["Z0"])) < 1e-12 and lay2.slices == p["lay"].slices
    rng = np.random.default_rng(13)
    Z = p["Z0"] + 0.05 * torch.as_tensor(rng.standard_normal((2, N, DZ)))
    lam = torch.as_tensor(rng.standard_normal((2, N, M)))
    for f in (lambda n, q: pt.solver.nlp_constraint_residuals(n, Z, None, q),
              lambda n, q: pt.solver.nlp_total_cost(n, Z, None, q),
              lambda n, q: pipm._derivatives(n, Z, q, lam)[3]):
        assert torch.allclose(f(p["nlp"], p["params"]), f(nlp2, params2), rtol=0,
                              atol=1e-12)
