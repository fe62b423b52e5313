"""Config 2 (the X gate on the 0-1 subspace of a 3-level transmon with
leakage suppression) in the port against piccolax, on the CPU in float64:
the Pedersen fidelities, the embedded rollout fidelity, the build at
N = 11, T = 4 (Z0 on the subspace geodesic, dz = 24, m = 22, the
trajectory's own fidelity), the Pedersen and leakage costs with their
derivatives, and the first IPM iterates with hess_mode="abs". One JAX
build, shared by the file. The building blocks (`TransmonSystem`, the
embedded-operator functions) are held in tests/test_torch_qutrit.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from piccolax import benchmarks as jbm  # noqa: E402
from piccolax.quantum import dynamics as jdyn  # noqa: E402
from piccolax.quantum import operators as jops  # noqa: E402
from piccolax.quantum.templates import TransmonSystem as JTransmon  # noqa: E402
from piccolax.solver import ipm as jipm  # noqa: E402
from piccolax.solver.nlp import nlp_constraint_residuals as jres  # noqa: E402
from piccolax.solver.nlp import nlp_total_cost as jcost  # noqa: E402
import piccolax_torch as pt  # noqa: E402
from piccolax_torch import _kernels  # noqa: E402
from piccolax_torch.quantum import dynamics as pdyn  # noqa: E402
from piccolax_torch.quantum import isomorphisms as piso  # noqa: E402
from piccolax_torch.quantum import operators as pops  # noqa: E402
from piccolax_torch.solver import ipm as pipm  # noqa: E402

N, T, M, DZ = 11, 4.0, 22, 24
OPTS = dict(max_iter=3, tol=1e-6, constr_viol_tol=1e-6, hess_mode="abs",
            prox_iter=3)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.fixture(scope="module")
def built():
    jprob = jbm.qutrit_x_problem(N=N, T=T)
    jnlp, jparams, jZ0, jg0, jlay = jprob.build()
    prob = pt.qutrit_x_problem(N=N, T=T, device="cpu")
    nlp, params, Z0, _, lay = prob.build(device="cpu")
    return dict(jprob=jprob, jnlp=jnlp, jparams=jparams, jZ0=np.asarray(jZ0),
                jg0=jg0, jlay=jlay, prob=prob, nlp=nlp, params=params, Z0=Z0,
                lay=lay)


def test_pedersen_fidelities_match_jax():
    """pedersen_fidelity, its iso forms (raw and bounded) and the subspace
    unitary fidelity on perturbed 3 x 3 operators, to 1e-12."""
    rng = np.random.default_rng(8)
    U = rng.standard_normal((4, 3, 3)) + 1j * rng.standard_normal((4, 3, 3))
    goal = pops.EmbeddedOperator(pt.GATES["X"], [0, 1], [3])
    sub = np.ix_([0, 1], [0, 1])
    Us, Gs = U[:, sub[0], sub[1]], goal.unembed()
    assert _rel(pdyn.pedersen_fidelity(torch.as_tensor(Us), Gs).numpy(),
                jdyn.pedersen_fidelity(jnp.asarray(Us), jnp.asarray(Gs))) < 1e-12
    assert _rel(pdyn.unitary_fidelity(torch.as_tensor(U), goal.operator, [0, 1]).numpy(),
                jdyn.unitary_fidelity(jnp.asarray(U), jnp.asarray(goal.operator),
                                      [0, 1])) < 1e-12
    x = piso.operator_to_iso_vec(U)
    g = piso.operator_to_iso_vec(goal.operator)
    idx = piso.operator_subspace_iso_indices(3, [0, 1])
    assert _rel(pdyn.pedersen_fidelity_iso(torch.as_tensor(x[:, idx]),
                                           torch.as_tensor(g[idx])).numpy(),
                jdyn.pedersen_fidelity_iso(jnp.asarray(x[:, idx]),
                                           jnp.asarray(g[idx]))) < 1e-12
    assert _rel(pdyn.pedersen_fidelity_iso_bounded(
        torch.as_tensor(x[:, idx]), torch.as_tensor(g[idx]), torch.as_tensor(x)).numpy(),
        jdyn.pedersen_fidelity_iso_bounded(jnp.asarray(x[:, idx]), jnp.asarray(g[idx]),
                                           jnp.asarray(x))) < 1e-12


def test_embedded_rollout_fidelity_matches_jax(built):
    """unitary_rollout_fidelity with an EmbeddedOperator goal (Pedersen
    fidelity of the 0-1 block of the final propagator), batched over two
    pulses, and the build's trajectory's own fidelity, to 1e-12."""
    sys_p = pt.TransmonSystem(levels=3, drive_bounds=0.2)
    sys_j = JTransmon(levels=3, drive_bounds=0.2)
    goal_p = pops.EmbeddedOperator(pt.GATES["X"], [0, 1], [3])
    goal_j = jops.EmbeddedOperator(np.asarray(pt.GATES["X"]), [0, 1], [3])
    rng = np.random.default_rng(9)
    us = 0.15 * rng.standard_normal((2, N, 2))
    times = np.linspace(0.0, T, N)
    F = pt.unitary_rollout_fidelity(sys_p, torch.as_tensor(us),
                                    np.tile(times, (2, 1)), goal_p,
                                    interpolation="constant", n_substeps=3,
                                    device="cpu")
    for b in range(2):
        ref = jdyn.unitary_rollout_fidelity(sys_j, us[b], times, goal_j,
                                            interpolation="constant", n_substeps=3)
        assert abs(F[b].item() - float(ref)) < 1e-12
    qt, jqt = built["prob"].qtraj, built["jprob"].qtraj
    assert abs(qt.fidelity().item() - float(jqt.fidelity())) < 1e-12
    assert qt.embedded_goal.subspace == (0, 1)
    assert np.array_equal(qt.rollout().goal, qt.goal)


def test_qutrit_build_matches_jax(built):
    """Layout U 0:18, u 18:20, du 20:22, ddu 22:24, m = 22; Z0 on the
    subspace geodesic, bounds, pins and the embedded goal's iso to 1e-12;
    the same squarings and objectives (Pedersen subspace, leakage)."""
    p = built
    assert p["lay"].slices == p["jlay"].slices
    assert p["nlp"].m == M and p["Z0"].shape == (N, DZ)
    assert np.max(np.abs(p["Z0"].numpy() - p["jZ0"])) < 1e-12
    for key in ("lo", "hi", "pin_mask"):
        a, b = getattr(p["nlp"], key).numpy(), np.asarray(getattr(p["jnlp"], key))
        assert np.array_equal(np.isfinite(a), np.isfinite(b))
        fin = np.isfinite(b)
        assert np.max(np.abs(a[fin] - b[fin]), initial=0.0) < 1e-12
    assert np.max(np.abs(p["params"]["pin_val"].numpy()
                         - np.asarray(p["jparams"]["pin_val"]))) < 1e-12
    assert np.array_equal(p["params"]["goal"]["U"].numpy(),
                          np.asarray(p["jparams"]["goal"]["U"]))
    assert p["prob"].integrators[0].squarings == p["jprob"].integrators[0].squarings
    names = [type(o).__name__ for o in p["prob"].objectives]
    assert names == [type(o).__name__ for o in p["jprob"].objectives]
    assert np.array_equal(p["prob"].objectives[0].subspace,
                          p["jprob"].objectives[0].subspace)
    assert np.array_equal(p["prob"].objectives[-1].indices,
                          p["jprob"].objectives[-1].indices)


def test_pedersen_and_leakage_derivatives_match_jax(built):
    """Residuals, cost (the Pedersen subspace infidelity and the leakage
    cost of every knot), Cself, Cnext, the cost gradient and the Lagrangian
    Hessians at a perturbed Z0 with random multipliers: 1e-10 relative;
    no kernel launched on the CPU."""
    p = built
    rng = np.random.default_rng(10)
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
    # the leakage cost reaches every knot's gradient, not only the last
    U = p["lay"].slices["U"]
    leak = np.asarray(p["jprob"].objectives[-1].indices)
    assert np.all(np.abs(g.numpy()[:-1, U][:, leak]) > 0)


def test_first_abs_iterates_match_jax(built):
    """Three IPM iterations with hess_mode="abs" (and prox_iter=3) from
    the build's Z0 against piccolax's IPM body: Z, lam and mu to 1e-8
    relative."""
    p = built
    s, jbody = jipm._setup(p["jnlp"], p["jparams"], jnp.asarray(p["jZ0"]), None,
                           jipm.IPMOptions(**OPTS))
    jbody = jax.jit(jbody)
    state, body = pipm._setup(p["nlp"], p["params"], p["Z0"][None], None,
                              pipm.IPMOptions(**OPTS))
    for it in range(3):
        s = jbody(s)
        state = body(state)
        for name in ("Z", "lam", "mu"):
            assert _rel(getattr(state, name)[0].numpy(),
                        getattr(s, name)) < 1e-8, (it, name)
