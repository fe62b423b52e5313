"""The port's NLP and batched IPM against piccolax on the SX-gate problem
(N = 11, T = 4), on the CPU in float64."""

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
from piccolax_torch.quantum.dynamics import unitary_fidelity_iso  # noqa: E402
from piccolax_torch.solver import ipm as pipm  # noqa: E402

N, T, B = 11, 4.0, 2
OPTS = dict(max_iter=60, tol=1e-6, constr_viol_tol=1e-6, newton_dir=False)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.fixture(scope="module")
def problems():
    jnlp, jparams, jZ0, jg0, jlay = jbm.sx_gate_problem(N=N, T=T).build()
    nlp, params, Z0, _, lay = pt.sx_gate_problem(N=N, T=T, device="cpu").build(
        device="cpu")
    rng = np.random.default_rng(11)
    Zb = np.repeat(np.asarray(jZ0)[None], B, 0)
    u = jlay.slices["u"]
    Zb[:, :, u] += 0.02 * rng.standard_normal((B, N, u.stop - u.start))
    return dict(jnlp=jnlp, jparams=jparams, jg0=jg0, nlp=nlp, params=params,
                layout=lay, Zb=Zb, rng=rng)


@pytest.fixture(scope="module")
def jax_solves(problems):
    """piccolax's IPM on each problem of the batch, one at a time as a
    vmapped while_loop runs it: the first five iterates and the final
    state (one jitted body per problem, shared by the tests below)."""
    p = problems
    jopts = jipm.IPMOptions(**OPTS)
    out = []
    for b in range(B):
        s, jbody = jipm._setup(p["jnlp"], p["jparams"], jnp.asarray(p["Zb"][b]),
                               None, jopts)
        jbody = jax.jit(jbody)
        first = []
        while int(s.it) < jopts.max_iter and not (bool(s.converged)
                                                  or bool(s.stalled)):
            s = jbody(s)
            if len(first) < 5:
                first.append(s)
        out.append((first, s))
    return out


def test_residuals_and_cost_match_jax(problems):
    p = problems
    Z = p["Zb"][0]
    c_ref = np.asarray(jres(p["jnlp"], jnp.asarray(Z), p["jg0"], p["jparams"]))
    f_ref = float(jcost(p["jnlp"], jnp.asarray(Z), p["jg0"], p["jparams"]))
    Zt = torch.as_tensor(p["Zb"])
    c = pt.solver.nlp_constraint_residuals(p["nlp"], Zt, None, p["params"])
    f = pt.solver.nlp_total_cost(p["nlp"], Zt, None, p["params"])
    assert c.shape == (B, N, 12)
    assert np.max(np.abs(c[0].numpy() - c_ref)) < 1e-10 * max(1, np.abs(c_ref).max())
    assert abs(f[0].item() - f_ref) < 1e-10 * max(1, abs(f_ref))


def test_jacobians_match_jax(problems):
    p = problems
    Z = p["Zb"][1]
    Cs, Cn, _ = jax.jit(lambda Zj: jipm._jacobians(
        p["jnlp"], Zj, p["jg0"], p["jparams"]))(jnp.asarray(Z))
    _, pCs, pCn, _ = pipm._derivatives(p["nlp"], torch.as_tensor(Z), p["params"],
                                       torch.zeros(N, 12, dtype=torch.float64))
    assert np.max(np.abs(pCs.numpy() - np.asarray(Cs))) < 1e-10
    assert np.max(np.abs(pCn.numpy() - np.asarray(Cn))) < 1e-10


def test_gradients_and_hessians_match_jax(problems):
    p = problems
    Z = p["Zb"][0]
    lam = p["rng"].standard_normal((N, 12))
    H, gz = jax.jit(lambda Zj, lj: (
        jipm._stage_hessians_split(p["jnlp"], Zj, p["jg0"], p["jparams"], lj),
        jipm._gradients(p["jnlp"], Zj, p["jg0"], p["jparams"])[0]))(
            jnp.asarray(Z), jnp.asarray(lam))
    g, _, _, pH = pipm._derivatives(p["nlp"], torch.as_tensor(Z), p["params"],
                                    torch.as_tensor(lam))
    assert np.max(np.abs(pH.numpy() - np.asarray(H))) < 1e-10 * np.abs(H).max()
    assert np.allclose(pH.numpy(), np.swapaxes(pH.numpy(), -1, -2), atol=0)
    assert np.max(np.abs(g.numpy() - np.asarray(gz))) < 1e-10


def test_first_iterates_match_jax(problems, jax_solves):
    """Five IPM iterations, batched in the port and one problem at a time
    in piccolax: Z, lam and mu agree to 1e-8 relative."""
    p = problems
    state, body = pipm._setup(p["nlp"], p["params"], torch.as_tensor(p["Zb"]),
                              None, pipm.IPMOptions(**OPTS))
    for it in range(5):
        state = body(state)
        for b in range(B):
            ref = jax_solves[b][0][it]
            for name in ("Z", "lam", "mu"):
                assert _rel(getattr(state, name)[b].numpy(),
                            getattr(ref, name)) < 1e-8, (it, b, name)


def test_batched_solve_matches_jax(problems, jax_solves):
    """The whole batched solve: per-problem converged flags as the vmapped
    while_loop gives them, and the final-knot fidelity to 1e-6."""
    p = problems
    _kernels.reset_launch_counts()
    st = pt.solve_nlp(p["nlp"], p["params"], torch.as_tensor(p["Zb"]),
                      options=pt.IPMOptions(**OPTS), device="cpu")
    assert all(v == 0 for v in _kernels.LAUNCHES.values())
    U = p["layout"].slices["U"]
    goal = p["params"]["goal"]["U"]
    for b in range(B):
        s = jax_solves[b][1]
        assert bool(st.converged[b]) == bool(s.converged)
        assert int(st.it[b]) == int(s.it)
        F_ref = unitary_fidelity_iso(torch.as_tensor(np.array(s.Z[-1, U])), goal)
        F = unitary_fidelity_iso(st.Z[b, -1, U], goal)
        assert abs(F.item() - F_ref.item()) < 1e-6
        assert F.item() > 0.999


def test_single_problem_float32_solve_converges(problems):
    """The float32 path (delta_c_f32, hess_floor_f32, bound_relax, order-8
    Taylor) on one problem given as [N, dz]."""
    p = problems
    Z0 = torch.as_tensor(p["Zb"][0], dtype=torch.float32)
    st = pt.solve_nlp(p["nlp"], p["params"], Z0, device="cpu",
                      options=pt.IPMOptions(max_iter=60, tol=5e-3,
                                            constr_viol_tol=5e-3,
                                            ls_iters=6, clamp_iters=15))
    assert st.Z.shape == (N, 14) and st.Z.dtype == torch.float32
    assert bool(st.converged)
    goal = p["params"]["goal"]["U"].float()
    assert unitary_fidelity_iso(st.Z[-1, p["layout"].slices["U"]], goal) > 0.99
