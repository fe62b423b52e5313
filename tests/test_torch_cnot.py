"""Config 3 (CNOT on two coupled transmons) in the port against piccolax, on
the CPU in float64: the copied operator builders, the build at a reduced
size (N = 12, T = 3; dz = 44, m = 40, K4's plain path on 8 x 8 residual
generators and 24 x 24 augmentations), the knot-partitioned IPM
(kkt_backend="knot", mesh=4) against piccolax's "knot" solve on a 4-device
virtual mesh, and the sequential quasidefinite IPM (kkt_backend="qd")
against piccolax's "qd" solve.

piccolax's side runs in two worker threads started by the module fixture:
its build, then its "knot" and "qd" IPMs (one jit of the while_loop each)
beside the jit of its derivatives. XLA compiles without the GIL, so the
compiles overlap each other and the port's side in the main thread."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from piccolax import benchmarks as jbm  # noqa: E402
from piccolax.quantum import operators as jops  # noqa: E402
from piccolax.solver import ipm as jipm  # noqa: E402
from piccolax.solver.nlp import nlp_constraint_residuals as jres  # noqa: E402
from piccolax.solver.nlp import nlp_total_cost as jcost  # noqa: E402
import piccolax_torch as pt  # noqa: E402
from piccolax_torch import _kernels  # noqa: E402
from piccolax_torch.quantum import operators as pops  # noqa: E402
from piccolax_torch.solver import ipm as pipm  # noqa: E402

N, T, M, DZ = 12, 3.0, 40, 44
KNOT_ITERS = 10
KNOT_OPTS = dict(max_iter=KNOT_ITERS, tol=1e-6, constr_viol_tol=1e-6,
                 kkt_backend="knot")
QD_OPTS = {**KNOT_OPTS, "kkt_backend": "qd"}


def _jax_build():
    jprob = jbm.cnot_problem(N=N, T=T)
    return (jprob, *jprob.build())


def _jax_knot_solve(jb):
    _, jnlp, jparams, jZ0, jg0, _ = jb.result()
    mesh = Mesh(np.array(jax.devices()[:4]), ("knot",))
    opts = jipm.IPMOptions(**KNOT_OPTS)
    st = jax.jit(lambda Z, g: jipm.solve_nlp(jnlp, jparams, Z, g, opts, mesh=mesh))(
        jZ0, jg0)
    return int(st.it), np.asarray(st.Z), float(st.kkt_err)


def _jax_qd_solve(jb):
    _, jnlp, jparams, jZ0, jg0, _ = jb.result()
    opts = jipm.IPMOptions(**QD_OPTS)
    st = jax.jit(lambda Z, g: jipm.solve_nlp(jnlp, jparams, Z, g, opts))(jZ0, jg0)
    return int(st.it), np.asarray(st.Z), float(st.kkt_err)


def _jax_derivatives(jb):
    """Residuals, cost, (Cself, Cnext) and the Lagrangian Hessians at Z0
    perturbed by 0.05 N(0, 1) with N(0, 1) multipliers (seed 3)."""
    _, jnlp, jparams, jZ0, jg0, _ = jb.result()
    rng = np.random.default_rng(3)
    Z = np.asarray(jZ0) + 0.05 * rng.standard_normal(jZ0.shape)
    lam = rng.standard_normal((N, M))
    out = jax.jit(lambda Zj, lj: (
        jres(jnlp, Zj, jg0, jparams), jcost(jnlp, Zj, jg0, jparams),
        jipm._jacobians(jnlp, Zj, jg0, jparams)[:2],
        jipm._stage_hessians_split(jnlp, Zj, jg0, jparams, lj)))(
            jnp.asarray(Z), jnp.asarray(lam))
    return Z, lam, jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def built():
    pool = ThreadPoolExecutor(2)
    jb = pool.submit(_jax_build)
    knot = pool.submit(_jax_knot_solve, jb)
    derivs = pool.submit(_jax_derivatives, jb)
    qd = pool.submit(_jax_qd_solve, jb)
    prob = pt.cnot_problem(N=N, T=T, device="cpu")
    nlp, params, Z0, _, lay = prob.build(device="cpu")
    jprob, jnlp, _, jZ0, _, jlay = jb.result()
    yield dict(jprob=jprob, jnlp=jnlp, jZ0=np.asarray(jZ0), jlay=jlay, prob=prob,
               nlp=nlp, params=params, Z0=Z0, lay=lay, knot=knot, derivs=derivs,
               qd=qd)
    pool.shutdown()


@pytest.mark.parametrize("name,args", [
    ("annihilate", (2,)), ("annihilate", (3,)), ("create", (3,)),
    ("number_op", (4,)), ("quad_op", (4,)),
    ("lift_operator", (np.array([[0, 1], [0, 0]]), 0, [2, 2])),
    ("lift_operator", (np.arange(9).reshape(3, 3) * 1j, 1, [2, 3, 2])),
])
def test_copied_operators_give_identical_outputs(name, args):
    a, b = getattr(pops, name)(*args), getattr(jops, name)(*args)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_cnot_build_matches_jax(built):
    """The same layout (U 0:32, u 32:36, du 36:40, ddu 40:44), m = 40, the
    same Z0, bounds and pins to 1e-12, and the same squaring count."""
    p = built
    assert p["lay"].slices == p["jlay"].slices
    assert p["nlp"].m == M and p["Z0"].shape == (N, DZ)
    assert np.max(np.abs(p["Z0"].numpy() - p["jZ0"])) < 1e-12
    for key in ("lo", "hi", "pin_mask"):
        a, b = getattr(p["nlp"], key).numpy(), np.asarray(getattr(p["jnlp"], key))
        assert np.array_equal(np.isfinite(a), np.isfinite(b))
        fin = np.isfinite(b)
        assert np.max(np.abs(a[fin] - b[fin]), initial=0.0) < 1e-12
    assert p["prob"].integrators[0].squarings == p["jprob"].integrators[0].squarings


def test_cnot_derivatives_match_jax(built):
    """Residuals, cost, Cself, Cnext and the Lagrangian Hessians at a
    perturbed Z0 with random multipliers, 1e-10 (Hessians relative to their
    largest entry); no kernel launched on the CPU."""
    p = built
    Z, lam, (c_ref, f_ref, (Cs, Cn), H) = p["derivs"].result()
    Zt = torch.as_tensor(Z)
    _kernels.reset_launch_counts()
    c = pt.solver.nlp_constraint_residuals(p["nlp"], Zt, None, p["params"])
    f = pt.solver.nlp_total_cost(p["nlp"], Zt, None, p["params"])
    _, pCs, pCn, pH = pipm._derivatives(p["nlp"], Zt, p["params"],
                                        torch.as_tensor(lam))
    assert all(v == 0 for v in _kernels.LAUNCHES.values())
    assert np.max(np.abs(c.numpy() - c_ref)) < 1e-10
    assert abs(float(f) - float(f_ref)) < 1e-10 * max(1.0, abs(float(f_ref)))
    assert np.max(np.abs(pCs.numpy() - Cs)) < 1e-10
    assert np.max(np.abs(pCn.numpy() - Cn)) < 1e-10
    assert np.max(np.abs(pH.numpy() - H)) < 1e-10 * np.abs(H).max()


def test_knot_ipm_matches_jax_knot_solve(built):
    """The port's solve_nlp(kkt_backend="knot", mesh=4) against piccolax's
    "knot" solve on a 4-device mesh, KNOT_ITERS iterations from the same
    Z0: the same it, Z to rtol 1e-7 / atol 1e-9 and kkt_err to rtol 1e-4,
    as tests/test_multichip.py holds piccolax's "knot" against "cr"."""
    p = built
    st = pt.solve_nlp(p["nlp"], p["params"], p["Z0"], device="cpu", mesh=4,
                      options=pt.IPMOptions(**KNOT_OPTS))
    it, Zj, kkt = p["knot"].result()
    assert int(st.it) == it == KNOT_ITERS
    np.testing.assert_allclose(st.Z.numpy(), Zj, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(float(st.kkt_err), kkt, rtol=1e-4)


def test_qd_ipm_matches_jax_qd_solve(built):
    """The port's solve_nlp(kkt_backend="qd") against piccolax's "qd"
    solve, KNOT_ITERS iterations from the same Z0: the same it, Z to rtol
    1e-7 / atol 1e-9 and kkt_err to rtol 1e-4, as the knot IPM is held."""
    p = built
    st = pt.solve_nlp(p["nlp"], p["params"], p["Z0"], device="cpu",
                      options=pt.IPMOptions(**QD_OPTS))
    it, Zj, kkt = p["qd"].result()
    assert int(st.it) == it == KNOT_ITERS
    np.testing.assert_allclose(st.Z.numpy(), Zj, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(float(st.kkt_err), kkt, rtol=1e-4)
