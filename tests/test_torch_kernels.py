"""The port's kernel modules against piccolax, on the CPU in float64.

On a CPU tensor every kernel wrapper runs its plain PyTorch version; the
same numpy inputs go through the JAX function and the port. Tolerances
are float64 rounding of different (but equivalent) operation orders.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from piccolax.solver import kkt as jkkt  # noqa: E402
from piccolax_torch import _kernels  # noqa: E402
from piccolax_torch.ops import expm as pexpm  # noqa: E402
from piccolax_torch.solver import kkt as pkkt  # noqa: E402

# piccolax.ops re-exports a function named expm over the module name
jexpm = importlib.import_module("piccolax.ops.expm")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _spd(rng, shape, m, shift=0.5):
    X = rng.standard_normal((*shape, m, m))
    A = X @ np.swapaxes(X, -1, -2) / m + shift * np.eye(m)
    # a wide diagonal range, as barrier terms give the KKT blocks
    s = np.exp(rng.uniform(-3, 3, (*shape, m)))
    return A * s[..., :, None] * s[..., None, :]


# -- K4: Taylor expm ---------------------------------------------------------


@pytest.mark.parametrize("order", [8, 12])
@pytest.mark.parametrize("n,squarings", [(4, 0), (4, 2), (12, 1)])
def test_expm_taylor_fixed_matches_jax(order, n, squarings):
    rng = np.random.default_rng(order * 100 + n + squarings)
    A = 0.3 * rng.standard_normal((6, n, n))
    ref = jexpm.expm_taylor_fixed(jnp.asarray(A), order, squarings)
    got = pexpm.expm_taylor_fixed(torch.as_tensor(A), order, squarings)
    assert _rel(got.numpy(), ref) < 1e-13


def test_expm_derivative_blocks_match_jax_autodiff():
    """The block-triangular augmentation gives the jacfwd / hessian of the
    same Taylor approximant (order 12, 2 squarings)."""
    rng = np.random.default_rng(7)
    A, E1, E2 = (0.4 * rng.standard_normal((4, 4)) for _ in range(3))

    def f(u):
        return jexpm.expm_taylor_fixed(
            jnp.asarray(A) + u[0] * jnp.asarray(E1) + u[1] * jnp.asarray(E2),
            12, 2)

    u0 = jnp.zeros(2)
    J = np.asarray(jax.jacfwd(f)(u0))              # [4, 4, 2]
    H = np.asarray(jax.hessian(f)(u0))             # [4, 4, 2, 2]
    Phi, dPhi, D2 = pexpm.expm_fixed_derivatives(
        torch.as_tensor(A), torch.as_tensor(np.stack([E1, E2])), "taylor", 2)
    assert _rel(Phi.numpy(), f(u0)) < 1e-13
    assert _rel(np.moveaxis(dPhi.numpy(), 0, -1), J) < 1e-10
    assert _rel(np.moveaxis(D2.numpy(), (0, 1), (-2, -1)), H) < 1e-10


def _directions(rng, w, d, radius, squarings, lead=(3,)):
    """A [*lead, w, w] at half the accuracy radius times 2^s (inf-norm) and
    directions E [*lead, d, w, w] of the same scale, float64."""
    A = rng.standard_normal((*lead, w, w))
    A *= 0.5 * radius * 2.0 ** squarings / np.abs(A).sum(-1).max(-1)[..., None, None]
    E = 0.3 * radius * 2.0 ** squarings * rng.standard_normal((*lead, d, w, w)) / w
    return torch.as_tensor(A), torch.as_tensor(E)


def _dense_derivatives(A, E, fn, order, squarings):
    """The oracle: the plain approximant on every dense augmentation, then
    its blocks (as `expm_fixed_derivatives_dense` slices them)."""
    w, d = A.shape[-1], E.shape[-3]
    R = fn(pexpm.derivative_augmentations(A, E), order, squarings).reshape(
        *A.shape[:-2], d, d, 3 * w, 3 * w)
    idx = torch.arange(d)
    half = R[..., :w, 2 * w:]
    return R[..., 0, 0, :w, :w], R[..., idx, idx, :w, w:2 * w], half + half.transpose(-3, -4)


@pytest.mark.parametrize("w,d", [(4, 2), (4, 3), (8, 4), (10, 5)])
@pytest.mark.parametrize("squarings", [0, 1, 2])
@pytest.mark.parametrize("order", [8, 12])
def test_expm_derivative_structured_matches_dense(order, squarings, w, d):
    """The structured plain form (D, F, S) of the Taylor approximant against
    the dense plain form on derivative_augmentations, 1e-13 relative."""
    rng = np.random.default_rng(100 * order + 10 * w + d + squarings)
    A, E = _directions(rng, w, d, pexpm.TAYLOR_THETA, squarings)
    got = pexpm.expm_fixed_derivatives_plain(A, E, "taylor", squarings, taylor_order=order)
    ref = _dense_derivatives(A, E, pexpm.expm_taylor_fixed_plain, order, squarings)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert _rel(g.numpy(), r.numpy()) < 1e-13
    if order == 12:                # the dispatching entry (float64: order 12)
        for g, r in zip(pexpm.expm_fixed_derivatives(A, E, "taylor", squarings), got):
            assert torch.equal(g, r)


@pytest.mark.parametrize("taylor_order", [8, 12])
def test_expm_derivative_blocks_match_jax_autodiff_8_wide(taylor_order):
    """The structured form at w = 8 and d = 4 (the CNOT's blocks) gives
    the jacfwd / hessian of piccolax's Taylor approximant (2 squarings)."""
    rng = np.random.default_rng(8 + taylor_order)
    A, E = _directions(rng, 8, 4, pexpm.TAYLOR_THETA, 2, lead=())
    An, En = A.numpy(), E.numpy()

    def f(u):
        return jexpm.expm_taylor_fixed(jnp.asarray(An) + jnp.tensordot(u, jnp.asarray(En), 1),
                                       taylor_order, 2)

    F, J, H = jax.jit(lambda u: (f(u), jax.jacfwd(f)(u), jax.hessian(f)(u)))(jnp.zeros(4))
    Phi, dPhi, D2 = pexpm.expm_fixed_derivatives_plain(A, E, "taylor", 2,
                                                       taylor_order=taylor_order)
    assert _rel(Phi.numpy(), F) < 1e-13
    assert _rel(np.moveaxis(dPhi.numpy(), 0, -1), np.asarray(J)) < 1e-10
    assert _rel(np.moveaxis(D2.numpy(), (0, 1), (-2, -1)), np.asarray(H)) < 1e-10


@pytest.mark.parametrize("shapes", [((2, 4, 4), (2, 3, 4, 5)), ((2, 4, 4), (3, 2, 4, 4)),
                                    ((2, 4, 4), (4, 4)), ((2, 4, 5), (2, 3, 4, 5)),
                                    ((2, 4, 4), (3, 2, 2, 4, 4))],
                         ids=["E-width", "E-batch", "E-no-directions", "A-not-square",
                              "E-wider-batch"])
def test_expm_fixed_derivatives_refuses_mismatched_shapes(shapes):
    """E [..., d, w, w] of A's width whose leading axes broadcast to A's."""
    A, E = (torch.zeros(s, dtype=torch.float64) for s in shapes)
    with pytest.raises(ValueError):
        pexpm.expm_fixed_derivatives(A, E, "taylor", 1)


# -- K1: Cholesky-inverse factor ---------------------------------------------


@pytest.mark.parametrize("m", [1, 12, 14, 15, 16, 17, 33, 44, 64])
def test_chol_inv_factor_matches_jax(m):
    rng = np.random.default_rng(m)
    A = _spd(rng, (3, 4), m)
    ref = np.asarray(jkkt.chol_inv_factor(jnp.asarray(A)))
    got = pkkt.chol_inv_factor(torch.as_tensor(A)).numpy()
    err = np.max(np.abs(got - ref), axis=(-2, -1)) / np.max(np.abs(ref), axis=(-2, -1))
    assert np.max(err) < 1e-12
    assert np.allclose(np.triu(got, 1), 0.0)


def test_chol_inv_factor_nan_mask_matches_jax():
    rng = np.random.default_rng(3)
    A = _spd(rng, (16,), 14)
    bad = np.array([1, 4, 5, 11])
    for k in bad:                                  # indefinite: one negative pivot
        w, V = np.linalg.eigh(A[k])
        w[rng.integers(14)] = -abs(w[0]) - 1.0
        A[k] = (V * w) @ V.T
    ref = np.asarray(jkkt.chol_inv_factor(jnp.asarray(A)))
    got = pkkt.chol_inv_factor(torch.as_tensor(A)).numpy()
    mask_ref = np.isnan(ref).any(axis=(-2, -1))
    mask_got = np.isnan(got).any(axis=(-2, -1))
    assert np.array_equal(mask_got, mask_ref)
    assert set(np.flatnonzero(mask_got)) == set(bad)
    ok = ~mask_ref
    assert _rel(got[ok], ref[ok]) < 1e-12


def test_chol_inv_factor_float32_zero_diagonal_floor():
    """sqrt(max(diag, 1e-300)) is max(diag, 0) in float32: a zero diagonal
    gives NaN, as in JAX's float32 path."""
    A = np.eye(3, dtype=np.float32)
    A[1, 1] = 0.0
    got = pkkt.chol_inv_factor(torch.as_tensor(A)).numpy()
    ref = np.asarray(jkkt.chol_inv_factor(jnp.asarray(A, jnp.float32)))
    assert ref.dtype == np.float32
    assert np.isnan(got).any() and not np.isfinite(ref).all()


# -- K2: Newton-Schulz PSD clamp ---------------------------------------------


@pytest.mark.parametrize("mode", ["pos", "abs"])
@pytest.mark.parametrize("iters,floor_rel", [(32, 1e-6), (15, 3e-3)])
@pytest.mark.parametrize("n", [14, 15, 44])
def test_psd_clamp_matches_jax(mode, iters, floor_rel, n):
    """Config 1's blocks (14), the quickstart's (15) and the CNOT's (44)."""
    rng = np.random.default_rng(iters)
    W = rng.standard_normal((5, n, n)) * 3.0
    W = 0.5 * (W + np.swapaxes(W, -1, -2))
    ref = np.asarray(jkkt.psd_clamp(jnp.asarray(W), floor_rel, iters, mode))
    got = pkkt.psd_clamp(torch.as_tensor(W), floor_rel, iters, mode).numpy()
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-11


@pytest.mark.parametrize("mode", ["pos", "abs"])
@pytest.mark.parametrize("n", [14, 15, 44])
def test_psd_clamp_nan_block_matches_jax(mode, n):
    """A NaN in one block makes that block, and no other, all NaN, as in
    JAX (the card's kernels are held to the same mask)."""
    rng = np.random.default_rng(n)
    W = rng.standard_normal((4, n, n))
    W = 0.5 * (W + np.swapaxes(W, -1, -2))
    W[2, n // 2, n - 1] = np.nan
    ref = np.asarray(jkkt.psd_clamp(jnp.asarray(W), 3e-3, 15, mode))
    got = pkkt.psd_clamp(torch.as_tensor(W), 3e-3, 15, mode).numpy()
    assert np.isnan(ref[2]).all() and np.isfinite(ref[[0, 1, 3]]).all()
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    ok = np.isfinite(ref)
    assert np.max(np.abs(got[ok] - ref[ok])) / np.max(np.abs(ref[ok])) < 1e-11


# -- K3: condensed KKT by cyclic reduction -----------------------------------


@pytest.mark.parametrize("N,m,dz,r", [pytest.param(11, 12, 14, 1, id="11"),
                                      pytest.param(16, 12, 14, 1, id="16"),
                                      pytest.param(13, 40, 44, 1, id="13-40-44"),
                                      pytest.param(2, 12, 14, 1, id="2"),
                                      pytest.param(16, 12, 14, 3, id="16-r3")])
def test_condensed_factor_and_solve_match_jax(N, m, dz, r):
    """Config 1's blocks (dz = 14, m = 12) and the CNOT's (44, 40); N = 2
    and N short of a power of two; r columns."""
    rng = np.random.default_rng(N)
    P = _spd(rng, (N,), dz, shift=1.0)
    C = rng.standard_normal((N, m, dz))
    Cn = rng.standard_normal((N - 1, m, dz))
    R = np.full((N, m), 1e-3)
    R[-1] += 1.0
    rhs = rng.standard_normal((N, dz + m, r))
    jf = jax.jit(jkkt.condensed_factor)(*(jnp.asarray(x) for x in (P, C, R, Cn)))
    ref = np.asarray(jax.jit(jkkt.condensed_solve, static_argnums=4)(
        jf, jnp.asarray(C), jnp.asarray(Cn), jnp.asarray(rhs), dz))
    T = [torch.as_tensor(x)[None] for x in (P, C, R, Cn)]
    pf = pkkt.condensed_factor(*T)
    got = pkkt.condensed_solve(pf, T[1], T[3], torch.as_tensor(rhs)[None], dz)
    assert _rel(got[0].numpy(), ref) < 1e-10
    # the factor itself: knot factors and every level's Cholesky inverse
    assert _rel(pf[0][0].numpy(), jf[0]) < 1e-10
    levels, Xi_root = jf[1]
    cr = pf[1][0].numpy()
    Np = cr.shape[1]
    off = 0
    for Xi_l, Ul, Ur in levels:
        h = Xi_l.shape[0]
        for plane, arr in enumerate((Xi_l, Ul, Ur)):
            assert _rel(cr[plane, off:off + h], arr) < 1e-10
        off += h
    assert off == Np - 1
    assert _rel(cr[0, Np - 1], Xi_root) < 1e-10


def test_cr_solve_is_an_exact_solve():
    """cr_factor/cr_solve (plain) solve an SPD block-tridiagonal system."""
    rng = np.random.default_rng(5)
    N, m = 11, 4
    X = rng.standard_normal((N, m, m))
    D = X @ np.swapaxes(X, -1, -2) / m + 2.0 * np.eye(m)
    U = 0.2 * rng.standard_normal((N - 1, m, m))
    S = np.zeros((N * m, N * m))
    for k in range(N):
        S[k * m:(k + 1) * m, k * m:(k + 1) * m] = D[k]
    for k in range(N - 1):
        S[k * m:(k + 1) * m, (k + 1) * m:(k + 2) * m] = U[k]
        S[(k + 1) * m:(k + 2) * m, k * m:(k + 1) * m] = U[k].T
    b = rng.standard_normal((N, m, 2))
    cr = pkkt.cr_factor(torch.as_tensor(D), torch.as_tensor(U))
    x = pkkt.cr_solve(cr, torch.as_tensor(b)).numpy()
    ref = np.linalg.solve(S, b.reshape(N * m, 2)).reshape(N, m, 2)
    assert _rel(x, ref) < 1e-10


def test_cpu_tensors_launch_nothing():
    _kernels.reset_launch_counts()
    A = torch.as_tensor(_spd(np.random.default_rng(0), (2,), 4))
    pkkt.chol_inv_factor(A)
    pkkt.psd_clamp(A, 1e-6, 4)
    pexpm.expm_taylor_fixed(A, 8, 0)
    assert all(v == 0 for v in _kernels.LAUNCHES.values())
