"""The sequential quasidefinite KKT (K7's plain versions) and the
lower-triangular inverse (K8's) against piccolax on the CPU in float64
(float32 where stated). piccolax's qd_factor / qd_solve take one problem;
they run here under jax.vmap, the port's with the batch leading."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from piccolax.solver import kkt as jkkt  # noqa: E402
import piccolax_torch as pt  # noqa: E402
from piccolax_torch import _kernels  # noqa: E402
from piccolax_torch.solver import kkt as pkkt  # noqa: E402

B = 3


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _kkt_problems(N, m, dz, seed, ill=False):
    """B problems built as tests/test_kkt.py's _kkt_problem builds one:
    P PD (ill: a 1e6 diagonal spread and a 1e-4 shift), C and Cnext
    N(0, 1), Rdiag 1e-6 (ill: 1e-8)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, N, dz, dz))
    P = X @ np.swapaxes(X, -1, -2) + 2 * dz * np.eye(dz)
    if ill:
        P[:, :, 0, 0] *= 1e6
        P += 1e-4 * np.eye(dz)
    C = rng.standard_normal((B, N, m, dz))
    Cn = rng.standard_normal((B, N - 1, m, dz))
    R = np.full((B, N, m), 1e-8 if ill else 1e-6)
    rhs = rng.standard_normal((B, N, dz + m, 2))
    return P, C, R, Cn, rhs


@functools.partial(jax.jit, static_argnums=5)
def _jax_qd_jit(P, C, R, Cn, rhs, dz):
    f = jax.vmap(jkkt.qd_factor)(P, C, R, Cn)
    x = jax.vmap(lambda f0, f1, c, cn, r: jkkt.qd_solve((f0, f1), c, cn, r, dz))(
        f[0], f[1], C, Cn, rhs)
    return f, x


def _jax_qd(P, C, R, Cn, rhs, dz, dtype=jnp.float64):
    f, x = _jax_qd_jit(*[jnp.asarray(a, dtype) for a in (P, C, R, Cn, rhs)], dz)
    return [np.asarray(a) for a in f], np.asarray(x)


def _port_qd(P, C, R, Cn, rhs, dz, dtype=torch.float64):
    T = [torch.as_tensor(x, dtype=dtype) for x in (P, C, R, Cn, rhs)]
    f = pkkt.qd_factor(*T[:4])
    x = pkkt.qd_solve(f, T[1], T[3], T[4], dz)
    return [a.numpy() for a in f], x.numpy()


def _dense_kkt(P, C, Rdiag, Cnext):
    """The full symmetric KKT of one problem, per-knot order (z, lam)."""
    N, m, dz = C.shape
    mb = dz + m
    K = np.zeros((N * mb, N * mb))
    for k in range(N):
        o = k * mb
        K[o:o + dz, o:o + dz] = P[k]
        K[o + dz:o + mb, o:o + dz] = C[k]
        K[o:o + dz, o + dz:o + mb] = C[k].T
        K[o + dz:o + mb, o + dz:o + mb] = -np.diag(Rdiag[k])
        if k < N - 1:
            on = (k + 1) * mb
            K[o + dz:o + mb, on:on + dz] = Cnext[k]
            K[on:on + dz, o + dz:o + mb] = Cnext[k].T
    return K


# -- K7: qd factor and solve ---------------------------------------------------


@pytest.mark.parametrize("N,m,dz", [(1, 3, 5), (2, 3, 5), (7, 3, 5), (50, 3, 5),
                                    (11, 13, 15), (12, 40, 44)])
def test_qd_factor_and_solve_match_jax(N, m, dz):
    """tests/test_kkt.py's shapes, the quickstart's block sizes (dz = 15,
    m = 13) and the CNOT's (dz = 44, m = 40), B = 3, two right-hand sides:
    the factors slot by slot and the solution to 1e-10 relative."""
    args = _kkt_problems(N, m, dz, seed=N + m)
    (jP, jS), jx = _jax_qd(*args, dz)
    (pP, pS), px_ = _port_qd(*args, dz)
    assert pP.shape == (B, N, dz, dz) and pS.shape == (B, N, m, m)
    assert _rel(pP, jP) < 1e-10
    assert _rel(pS, jS) < 1e-10
    assert _rel(px_, jx) < 1e-10


def test_qd_solve_is_an_exact_solve():
    """Against the dense KKT of each problem (numpy), 1e-8 relative."""
    N, m, dz = 7, 3, 5
    P, C, R, Cn, rhs = _kkt_problems(N, m, dz, seed=1)
    _, x = _port_qd(P, C, R, Cn, rhs, dz)
    for b in range(B):
        K = _dense_kkt(P[b], C[b], R[b], Cn[b])
        ref = np.linalg.solve(K, rhs[b].reshape(N * (dz + m), 2))
        assert _rel(x[b].reshape(-1, 2), ref) < 1e-8


def test_qd_ill_conditioned_matches_jax():
    """tests/test_kkt.py's ill-conditioned blocks: the Gram-product Schur
    complements keep every factor finite and the two agree to 1e-10."""
    args = _kkt_problems(12, 3, 5, seed=60, ill=True)
    (jP, jS), jx = _jax_qd(*args, 5)
    (pP, pS), px_ = _port_qd(*args, 5)
    assert np.all(np.isfinite(pP)) and np.all(np.isfinite(pS))
    assert _rel(pP, jP) < 1e-10
    assert _rel(pS, jS) < 1e-10
    assert _rel(px_, jx) < 1e-10


def test_qd_float32_residual():
    """Float32 (R = 1e-3), held to test_kkt_backends_float32's residual
    bound against the dense float64 KKT of each problem, and finite."""
    N, m, dz = 20, 3, 5
    P, C, _, Cn, rhs = _kkt_problems(N, m, dz, seed=80)
    R = np.full((B, N, m), 1e-3)
    rhs = rhs[..., :1]
    _, x = _port_qd(P, C, R, Cn, rhs, dz, torch.float32)
    assert np.all(np.isfinite(x))
    for b in range(B):
        K = _dense_kkt(P[b], C[b], R[b], Cn[b])
        resid = np.abs(K @ x[b].astype(np.float64).ravel() - rhs[b].ravel()).max()
        assert resid < 5e-3 * np.abs(rhs[b]).max() * np.abs(K).max()


def test_qd_nan_mask_matches_jax():
    """One indefinite P block (problem 1, knot 4): NaN from that knot on in
    that problem, the same [B, N] mask as piccolax under vmap; the other
    problems stay finite."""
    N, m, dz = 9, 3, 4
    P, C, R, Cn, rhs = _kkt_problems(N, m, dz, seed=70)
    P[1, 4] -= 100.0 * np.eye(dz)
    (jP, jS), jx = _jax_qd(P, C, R, Cn, rhs, dz)
    (pP, pS), px_ = _port_qd(P, C, R, Cn, rhs, dz)
    for a, b in ((pP, jP), (pS, jS)):
        mask = np.isnan(a).any(axis=(-2, -1))
        assert np.array_equal(mask, np.isnan(b).any(axis=(-2, -1)))
        assert mask[1, 4:].all() and not mask[1, :4].any()
        assert not mask[[0, 2]].any()
    bad = np.isnan(px_).any(axis=(-3, -2, -1))
    assert np.array_equal(bad, np.isnan(jx).any(axis=(-3, -2, -1)))
    assert list(bad) == [False, True, False]
    ok = [0, 2]
    assert _rel(px_[ok], jx[ok]) < 1e-10


# -- K8: lower-triangular inverse -----------------------------------------------


@pytest.mark.parametrize("m", [1, 2, 5, 16, 32, 44, 64])
def test_tri_lower_inv_matches_jax(m):
    rng = np.random.default_rng(m)
    L = np.tril(rng.standard_normal((4, m, m)))
    d = np.arange(m)
    L[:, d, d] = 1.0 + np.abs(L[:, d, d])
    ref = np.asarray(jax.jit(jkkt.tri_lower_inv)(jnp.asarray(L)))
    got = pkkt.tri_lower_inv(torch.as_tensor(L)).numpy()
    assert _rel(got, ref) < 1e-13
    assert np.allclose(np.triu(got, 1), 0.0)


# -- guards --------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["native", "knot"])
def test_unported_kkt_backends_still_raise(backend):
    """"native" is not ported: NotImplementedError naming the ported
    backends. "knot" is, and without solve_nlp(mesh=...) raises piccolax's
    ValueError."""
    nlp, params, Z0, _, _ = pt.sx_gate_problem(N=11, T=2.0, device="cpu").build(
        device="cpu")
    err, match = ((NotImplementedError, "'cr', 'qd', 'knot'") if backend == "native"
                  else (ValueError, "needs solve_nlp"))
    with pytest.raises(err, match=match):
        pt.solve_nlp(nlp, params, Z0[None], device="cpu",
                     options=pt.IPMOptions(kkt_backend=backend))


def test_cpu_qd_and_tri_launch_nothing():
    _kernels.reset_launch_counts()
    P, C, R, Cn, rhs = _kkt_problems(3, 2, 3, seed=0)
    _port_qd(P, C, R, Cn, rhs, 3)
    pkkt.tri_lower_inv(torch.eye(3, dtype=torch.float64))
    assert all(v == 0 for v in _kernels.LAUNCHES.values())
