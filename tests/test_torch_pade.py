"""The fixed-order Pade expm (K6's plain version) and the Pade collocation
build (SmoothPulseProblem(pade_order=7)) against piccolax, on the CPU in
float64 (float32 where stated): the approximant of every order, its exact
derivatives through the block-triangular augmentation, and the reduced
quickstart's residuals, Jacobian blocks and Hessians with free timesteps."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import piccolax as px  # noqa: E402
from piccolax.solver import ipm as jipm  # noqa: E402
from piccolax.solver.nlp import nlp_constraint_residuals as jres  # noqa: E402
import piccolax_torch as pt  # noqa: E402
from piccolax_torch import _kernels  # noqa: E402
from piccolax_torch.control import integrators as pint  # noqa: E402
from piccolax_torch.ops import expm as pexpm  # noqa: E402
from piccolax_torch.solver import ipm as pipm  # noqa: E402

# piccolax.ops re-exports a function named expm over the module name
jexpm = importlib.import_module("piccolax.ops.expm")
jint = importlib.import_module("piccolax.control.integrators")

N, T = 18, 3.0


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _inside_radius(rng, shape, n, order, squarings):
    """Matrices whose inf-norms are 0.2 to 0.5 of the order's radius times
    2^squarings (near order 9's radius the 6 Newton-Schulz steps do not
    converge on 4 x 4 matrices)."""
    A = rng.standard_normal((*shape, n, n))
    A /= np.abs(A).sum(-1).max(-1)[..., None, None]
    return A * (pexpm.pade_radius(order) * 2.0 ** squarings
                * rng.uniform(0.2, 0.5, shape))[..., None, None]


# -- K6: the approximant -------------------------------------------------------


@pytest.mark.parametrize("n", [4, 12])
@pytest.mark.parametrize("order", [3, 5, 7, 9])
def test_expm_pade_fixed_matches_jax(order, n):
    """Squarings 0, 1 and 2; float64 to 1e-13 and float32 to 1e-5,
    relative to the largest entry."""
    rng = np.random.default_rng(10 * order + n)
    for s in (0, 1, 2):
        A = _inside_radius(rng, (5,), n, order, s)
        ref = jexpm.expm_pade_fixed(jnp.asarray(A), order, s)
        got = pexpm.expm_pade_fixed(torch.as_tensor(A), order, s)
        assert _rel(got.numpy(), ref) < 1e-13, s
        ref32 = jexpm.expm_pade_fixed(jnp.asarray(A, jnp.float32), order, s)
        got32 = pexpm.expm_pade_fixed(torch.as_tensor(A, dtype=torch.float32),
                                      order, s)
        assert got32.dtype == torch.float32
        assert _rel(got32.numpy(), ref32) < 1e-5, s


def test_expm_action_matches_jax():
    rng = np.random.default_rng(3)
    A = _inside_radius(rng, (3,), 6, 7, 2)
    x = rng.standard_normal((3, 6, 2))
    ref = jexpm.expm_action(jnp.asarray(A), jnp.asarray(x), 7, 2)
    got = pt.ops.expm_action(torch.as_tensor(A), torch.as_tensor(x), 7, 2)
    assert _rel(got.numpy(), ref) < 1e-13


def test_expm_fixed_dispatches_pade_orders():
    A = torch.as_tensor(_inside_radius(np.random.default_rng(4), (2,), 4, 5, 1))
    assert torch.equal(pexpm.expm_fixed(A, 5, 1), pexpm.expm_pade_fixed_plain(A, 5, 1))
    with pytest.raises(ValueError):
        pexpm.expm_fixed(A, 4, 1)


def test_pade_derivative_blocks_match_jax_autodiff():
    """The augmentation through the Pade approximant (order 7, Newton-
    Schulz inverse included) gives the jacfwd / hessian of piccolax's
    expm_pade_fixed to 1e-10 relative, at s = 0 and s = 1."""
    rng = np.random.default_rng(7)
    for s in (0, 1):
        A = _inside_radius(rng, (), 4, 7, s)
        E1, E2 = 0.3 * rng.standard_normal((2, 4, 4))

        def f(u):
            return jexpm.expm_pade_fixed(
                jnp.asarray(A) + u[0] * jnp.asarray(E1) + u[1] * jnp.asarray(E2),
                7, s)

        F, J, H = jax.jit(lambda u: (f(u), jax.jacfwd(f)(u), jax.hessian(f)(u)))(
            jnp.zeros(2))                              # J [4, 4, 2], H [4, 4, 2, 2]
        Phi, dPhi, D2 = pexpm.expm_fixed_derivatives(
            torch.as_tensor(A), torch.as_tensor(np.stack([E1, E2])), 7, s)
        assert _rel(Phi.numpy(), F) < 1e-13
        assert _rel(np.moveaxis(dPhi.numpy(), 0, -1), np.asarray(J)) < 1e-10
        assert _rel(np.moveaxis(D2.numpy(), (0, 1), (-2, -1)), np.asarray(H)) < 1e-10


# -- the Pade build ------------------------------------------------------------


def _quickstart(mod, pade_order=7, **kw):
    sysm = mod.QuantumSystem(0.5 * mod.PAULIS["Z"],
                             [mod.PAULIS["X"], mod.PAULIS["Y"]], 1.0)
    times = np.linspace(0.0, T, N)
    pulse = mod.ZeroOrderPulse(
        0.1 * np.random.default_rng(0).standard_normal((N, 2)), times)
    qtraj = mod.UnitaryTrajectory(sysm, pulse, mod.GATES["X"], **kw)
    return mod.SmoothPulseProblem(qtraj, N, Q=100.0, R=1e-2, ddu_bound=1.0,
                                  dt_bounds=(0.05, 0.2), pade_order=pade_order)


@pytest.fixture(scope="module")
def built():
    jqcp = _quickstart(px)
    qcp = _quickstart(pt, device="cpu")
    jnlp, jparams, jZ0, jg0, _ = jqcp.build()
    nlp, params, Z0, _, _ = qcp.build(device="cpu")
    return dict(jqcp=jqcp, qcp=qcp, jnlp=jnlp, jparams=jparams, jg0=jg0,
                nlp=nlp, params=params, Z0=Z0, jZ0=np.asarray(jZ0))


def test_pade_build_matches_jax(built):
    """The same Z0 and the same squaring count (0: the bound on ||dt G||
    is 0.5, inside Pade-7's 0.95), passed through to the integrator."""
    p = built
    jb, b = p["jqcp"].integrators[0], p["qcp"].integrators[0]
    assert b.order == jb.order == 7
    assert b.squarings == jb.squarings == 0
    assert np.max(np.abs(p["Z0"].numpy() - p["jZ0"])) < 1e-12


def test_pade_derivatives_match_jax(built):
    """Residuals, Cself, Cnext and Hext at a perturbed Z0 with random
    multipliers to 1e-10, including the dt column and the (dt, u)
    entries."""
    p = built
    rng = np.random.default_rng(5)
    Z = p["jZ0"] + 0.05 * rng.standard_normal(p["jZ0"].shape)
    lam = rng.standard_normal((N, 13))
    c_ref, (Cs, Cn, _), H = jax.jit(lambda Zj, lj: (
        jres(p["jnlp"], Zj, p["jg0"], p["jparams"]),
        jipm._jacobians(p["jnlp"], Zj, p["jg0"], p["jparams"]),
        jipm._stage_hessians_split(p["jnlp"], Zj, p["jg0"], p["jparams"], lj)))(
            jnp.asarray(Z), jnp.asarray(lam))
    Zt = torch.as_tensor(Z)
    _kernels.reset_launch_counts()
    c = pt.solver.nlp_constraint_residuals(p["nlp"], Zt, None, p["params"])
    _, pCs, pCn, pH = pipm._derivatives(p["nlp"], Zt, p["params"],
                                        torch.as_tensor(lam))
    assert all(v == 0 for v in _kernels.LAUNCHES.values())
    H, Cs = np.asarray(H), np.asarray(Cs)
    assert np.max(np.abs(c.numpy() - np.asarray(c_ref))) < 1e-10
    assert np.max(np.abs(pCs.numpy() - Cs)) < 1e-10
    assert np.max(np.abs(pCn.numpy() - np.asarray(Cn))) < 1e-10
    assert np.max(np.abs(pH.numpy() - H)) < 1e-10 * np.abs(H).max()
    dt, u = 10, slice(8, 10)
    assert np.abs(Cs[:-1, :8, dt]).max(axis=1).min() > 0
    assert np.abs(H[:-1, dt, u]).min() > 0


def test_pade_and_taylor_propagators_agree(built):
    """Both approximants are accurate to float64 rounding inside their
    radii, so the two builds' residuals agree to 1e-13 at Z0."""
    p = built
    nlp_t, params_t, _, _, _ = _quickstart(pt, "taylor", device="cpu").build(
        device="cpu")
    a = pt.solver.nlp_constraint_residuals(p["nlp"], p["Z0"], None, p["params"])
    b = pt.solver.nlp_constraint_residuals(nlp_t, p["Z0"], None, params_t)
    assert torch.max(torch.abs(a - b)) < 1e-13


# -- guards --------------------------------------------------------------------


@pytest.mark.parametrize("order", [4, 13, "pade"])
def test_unsupported_pade_order_raises_at_build(order):
    """piccolax refuses these in choose_squarings; the port refuses them
    there too, before any propagator is formed."""
    with pytest.raises(KeyError):
        jint.choose_squarings(0.5, order)
    with pytest.raises(ValueError, match="pade_order"):
        pt.sx_gate_problem(N=11, T=2.0, device="cpu", pade_order=order)


@pytest.mark.parametrize("order", [3, 5, 7, 9])
def test_choose_squarings_matches_jax(order):
    for norm in (0.01, 0.3, 0.5, 0.95, 1.7, 6.0):
        assert pint.choose_squarings(norm, order) == jint.choose_squarings(norm, order)


def test_cpu_pade_launches_nothing():
    _kernels.reset_launch_counts()
    A = torch.as_tensor(_inside_radius(np.random.default_rng(0), (2,), 4, 7, 0))
    pexpm.expm_pade_fixed(A, 7, 0)
    pt.ops.expm_action(A, A, 7, 0)
    assert all(v == 0 for v in _kernels.LAUNCHES.values())
