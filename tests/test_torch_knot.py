"""The knot-partitioned KKT (K9's plain versions) against piccolax's
parallel/sharded_kkt.py on the CPU in float64: piccolax's functions run
jitted on tests/conftest.py's virtual CPU mesh, the port's with the same
number of partitions P on one device. The 2D batched form is held against
piccolax's single-device spd_tridiag_solve_ref system by system."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from piccolax.parallel import sharded_kkt as jsk  # noqa: E402
import piccolax_torch as pt  # noqa: E402
from piccolax_torch import _kernels  # noqa: E402
from piccolax_torch.parallel import sharded_kkt as psk  # noqa: E402


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _packed(cr):
    """piccolax's cr_factor output (levels of (Xi, Ul, Ur), root Xi) in the
    port's packed layout [3, Np, m, m]."""
    levels, root = cr
    zero = np.zeros((1, *np.shape(root)))
    return np.stack([np.concatenate([*(np.asarray(lv[i]) for lv in levels),
                                     np.asarray(root)[None] if i == 0 else zero])
                     for i in range(3)])


def _mesh(P):
    return Mesh(np.array(jax.devices()[:P]), ("knot",))


def _spd_tridiag(N, m, seed, lead=()):
    """tests/test_multichip.py's systems: diag A A^T + 4m I, upper N(0, 1)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((*lead, N, m, m))
    diag = A @ np.swapaxes(A, -1, -2) + (4 * m) * np.eye(m)
    return diag, rng.standard_normal((*lead, N - 1, m, m))


def _kkt_blocks(N, m, dz, seed):
    """One problem's condensed-KKT blocks as tests/test_kkt.py builds them:
    P PD, C and Cnext N(0, 1), Rdiag 1e-6; two right-hand sides."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, dz, dz))
    P = X @ np.swapaxes(X, -1, -2) + 2 * dz * np.eye(dz)
    return (P, rng.standard_normal((N, m, dz)), np.full((N, m), 1e-6),
            rng.standard_normal((N - 1, m, dz)), rng.standard_normal((N, dz + m, 2)))


@pytest.mark.parametrize("P,r", [(2, None), (4, None), (4, 3)])
def test_sharded_tridiag_solve_matches_jax(P, r):
    """N = 24, m = 4, one or three right-hand sides: 1e-9 relative."""
    N, m = 24, 4
    diag, upper = _spd_tridiag(N, m, seed=P)
    rng = np.random.default_rng(1)
    rhs = rng.standard_normal((N, m) if r is None else (N, m, r))
    ref = jax.jit(lambda d, u, b: jsk.sharded_spd_tridiag_solve(d, u, b, _mesh(P)))(
        jnp.asarray(diag), jnp.asarray(upper), jnp.asarray(rhs))
    got = psk.sharded_spd_tridiag_solve(torch.as_tensor(diag), torch.as_tensor(upper),
                                        torch.as_tensor(rhs), P)
    assert got.shape == rhs.shape
    assert _rel(got, ref) < 1e-9


def test_batched_tridiag_solve_matches_jax_reference():
    """B = 3 systems (N = 24, m = 4, P = 4, two right-hand sides), each
    against piccolax's single-device spd_tridiag_solve_ref: 1e-9 relative."""
    B, N, m, P = 3, 24, 4, 4
    diag, upper = _spd_tridiag(N, m, seed=7, lead=(B,))
    rhs = np.random.default_rng(2).standard_normal((B, N, m, 2))
    got = psk.batched_sharded_spd_tridiag_solve(
        torch.as_tensor(diag), torch.as_tensor(upper), torch.as_tensor(rhs), P)
    ref_fn = jax.jit(jsk.spd_tridiag_solve_ref)
    for b in range(B):
        ref = ref_fn(jnp.asarray(diag[b]), jnp.asarray(upper[b]), jnp.asarray(rhs[b]))
        assert _rel(got[b], ref) < 1e-9


@pytest.mark.parametrize("N,m,dz,P", [(12, 3, 5, 4), (16, 4, 6, 2), (24, 2, 3, 8),
                                      (32, 2, 3, 8)])
def test_knot_condensed_factor_and_solve_match_jax(N, m, dz, P):
    """The factor's interface system and the solve of two right-hand sides
    against piccolax's knot_condensed_factor / _solve on a P-device mesh,
    1e-9 relative; the solve also against piccolax's unpartitioned
    condensed solve ("cr"), 1e-9. N = 3P and 4P are the partition edges
    (one interior knot; two, padded to one CR level)."""
    from piccolax.solver import kkt as jkkt
    Pm, C, R, Cn, rhs = _kkt_blocks(N, m, dz, seed=N + P)

    @jax.jit
    def ref(Pm, C, R, Cn, rhs):
        f = jsk.knot_condensed_factor(Pm, C, R, Cn, _mesh(P))
        x_cr = jkkt.condensed_solve(jkkt.condensed_factor(Pm, C, R, Cn), C, Cn, rhs, dz)
        return f[1]["f_if"], jsk.knot_condensed_solve(f, rhs, _mesh(P), "knot", dz), x_cr

    f_if, x_ref, x_cr = ref(*[jnp.asarray(a) for a in (Pm, C, R, Cn, rhs)])
    T = [torch.as_tensor(a)[None] for a in (Pm, C, R, Cn, rhs)]
    f = psk.knot_condensed_factor(*T[:4], P)
    x = psk.knot_condensed_solve(f, T[4], P, dz)[0]
    # the interface factor: the Xi, Ul, Ur planes of every CR slot
    assert _rel(f["f_if"][0], _packed(f_if)) < 1e-9
    assert _rel(x, x_ref) < 1e-9
    assert _rel(x, x_cr) < 1e-9
    # one right-hand side without the trailing axis
    x1 = psk.knot_condensed_solve(f, T[4][..., 0], P, dz)[0]
    assert _rel(x1, x_ref[..., 0]) < 1e-9


@pytest.mark.parametrize("fn", ["sharded", "batched", "factor"])
def test_bad_partition_raises(fn):
    """N = 10 over 4 partitions (not divisible) and N = 8 over 4 (chunks of
    2 < 3) raise ValueError, as in piccolax."""
    for N in (10, 8):
        diag, upper = (torch.as_tensor(a) for a in _spd_tridiag(N, 3, seed=0))
        with pytest.raises(ValueError, match="chunks >= 3"):
            if fn == "sharded":
                psk.sharded_spd_tridiag_solve(diag, upper, torch.zeros(N, 3), 4)
            elif fn == "batched":
                psk.batched_sharded_spd_tridiag_solve(diag[None], upper[None],
                                                      torch.zeros(1, N, 3), 4)
            else:
                psk.knot_condensed_factor(diag[None], torch.zeros(1, N, 2, 3),
                                          torch.ones(1, N, 2),
                                          torch.zeros(1, N - 1, 2, 3), 4)


def test_knot_backend_guards():
    """solve_nlp with kkt_backend="knot": ValueError without mesh (as
    piccolax), for a batch of two problems (piccolax's knot path is not
    vmappable) and for a partition count that does not tile N = 11."""
    nlp, params, Z0, _, _ = pt.sx_gate_problem(N=11, T=2.0, device="cpu").build(
        device="cpu")
    opts = pt.IPMOptions(kkt_backend="knot", max_iter=1)
    with pytest.raises(ValueError, match="mesh"):
        pt.solve_nlp(nlp, params, Z0, options=opts, device="cpu")
    with pytest.raises(ValueError, match="one problem"):
        pt.solve_nlp(nlp, params, torch.stack([Z0, Z0]), options=opts,
                     device="cpu", mesh=1)
    with pytest.raises(ValueError, match="chunks >= 3"):
        pt.solve_nlp(nlp, params, Z0, options=opts, device="cpu", mesh=2)


def test_cpu_knot_launches_nothing():
    _kernels.reset_launch_counts()
    Pm, C, R, Cn, rhs = _kkt_blocks(6, 2, 3, seed=0)
    T = [torch.as_tensor(a)[None] for a in (Pm, C, R, Cn, rhs)]
    psk.knot_condensed_solve(psk.knot_condensed_factor(*T[:4], 2), T[4], 2, 3)
    diag, upper = (torch.as_tensor(a) for a in _spd_tridiag(6, 2, seed=0))
    psk.sharded_spd_tridiag_solve(diag, upper, torch.ones(6, 2, dtype=diag.dtype), 2)
    assert all(v == 0 for v in _kernels.LAUNCHES.values())
