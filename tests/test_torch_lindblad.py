"""Config 5's building blocks in the port against piccolax, on the CPU in
float64: the density isos (full and compact), the lift and projection
maps, the superoperators, `OpenQuantumSystem` (its Liouvillians, its
right-hand side and its solver view), the density fidelities (with the
compact iso's missing sqrt(2) pinned to piccolax's value) and the
Lindblad rollout. The solver-side parity of config 5 (the build, the
costs, the integrator's derivatives, the iterates and a full solve) is
in tests/test_torch_lindblad_build.py, kept apart: pytest-xdist's loadfile
schedule hands out files with more tests first."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from piccolax.ops.expm import expm as jax_expm  # noqa: E402
from piccolax.quantum import dynamics as jdyn  # noqa: E402
from piccolax.quantum import isomorphisms as jiso  # noqa: E402
from piccolax.quantum import systems as jsys  # noqa: E402
from piccolax.quantum.pulses import ZeroOrderPulse as JZOH  # noqa: E402
import piccolax_torch as pt  # noqa: E402
from piccolax_torch import _kernels  # noqa: E402
from piccolax_torch.ops import expm as pexpm  # noqa: E402
from piccolax_torch.quantum import dynamics as pdyn  # noqa: E402
from piccolax_torch.quantum import isomorphisms as piso  # noqa: E402
from piccolax_torch.quantum import systems as psys  # noqa: E402


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _j(fn, *args):
    """A piccolax function's value, jitted (one compile instead of one a
    primitive), as numpy."""
    return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(*args))


def _herm(rng, n, scale=1.0):
    X = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    return scale * (X + X.conj().T) / 2


def _density(rng, lead, n):
    """Random density matrices [*lead, n, n] (Hermitian, PSD, trace 1)."""
    X = rng.standard_normal((*lead, n, n)) + 1j * rng.standard_normal((*lead, n, n))
    rho = X @ np.conj(np.swapaxes(X, -1, -2))
    return rho / np.trace(rho, axis1=-2, axis2=-1)[..., None, None]


def _systems(n, seed):
    """The same open system (random Hermitian drift and two drives, two
    jump operators with rates) in the port and in piccolax."""
    rng = np.random.default_rng(seed)
    H0, Hd = _herm(rng, n), [_herm(rng, n, 0.5) for _ in range(2)]
    Ls = [rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
          for _ in range(2)]
    rates = [0.03, 0.2]
    sp = psys.OpenQuantumSystem(H0, Hd, 1.0, dissipators=[
        psys.LinearDissipator(L, r) for L, r in zip(Ls, rates)])
    sj = jsys.OpenQuantumSystem(H0, Hd, 1.0, dissipators=[
        jsys.LinearDissipator(L, r) for L, r in zip(Ls, rates)])
    return sp, sj, rng


@pytest.mark.parametrize("n", [2, 3])
def test_density_isos_match_jax(n):
    """density_to_iso_vec / iso_vec_to_density and the compact iso round
    trip, batched; the compact index maps."""
    rng = np.random.default_rng(n)
    rho = _density(rng, (3,), n)
    full = piso.density_to_iso_vec(rho)
    j_full, j_x, j_back = _j(lambda r: (jiso.density_to_iso_vec(r),
                                        jiso.density_to_compact_iso(r),
                                        jiso.compact_iso_to_density(
                                            jiso.density_to_compact_iso(r))), rho)
    assert _rel(full, j_full) < 1e-15
    assert _rel(piso.iso_vec_to_density(full), rho) < 1e-15
    x = piso.density_to_compact_iso(rho)
    assert np.array_equal(x, j_x)
    assert x.shape == (3, n * n)
    back = piso.compact_iso_to_density(x)
    assert back.dtype == np.complex128 and _rel(back, rho) < 1e-15
    assert np.array_equal(piso.compact_iso_to_density(x), j_back)
    assert piso.compact_iso_to_density(x.astype(np.float32)).dtype == np.complex64
    for a, b in zip(piso._compact_indices(n), jiso._compact_indices(n), strict=True):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("n", [2, 3, 5])
def test_lift_and_projection_match_jax(n):
    """The lift L (compact -> full density iso-vec) and projection P
    equal piccolax's; P L = I; L maps a compact iso to the full one."""
    Lf, P = piso.density_lift_matrix(n), piso.density_projection_matrix(n)
    assert np.array_equal(Lf, np.asarray(jiso.density_lift_matrix(n)))
    assert np.array_equal(P, np.asarray(jiso.density_projection_matrix(n)))
    assert np.array_equal(P @ Lf, np.eye(n * n))
    rho = _density(np.random.default_rng(10 + n), (), n)
    assert _rel(Lf @ piso.density_to_compact_iso(rho), piso.density_to_iso_vec(rho)) < 1e-15


@pytest.mark.parametrize("n", [2, 3])
def test_superoperators_match_jax(n):
    """ad_vec (commutator and anticommutator, on arrays and batched
    tensors) and iso_D to 1e-12."""
    rng = np.random.default_rng(20 + n)
    H = _herm(rng, n)
    L = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    refs = _j(lambda H, L: (jiso.ad_vec(H), jiso.ad_vec(H, anti=True), jiso.iso_D(L),
                            jiso.iso(H)), H, L)
    for anti, ref in ((False, refs[0]), (True, refs[1])):
        assert _rel(piso.ad_vec(H, anti=anti), ref) < 1e-12
        Hb = torch.as_tensor(np.stack([H, 2 * H]))
        got = piso.ad_vec(Hb, anti=anti).numpy()
        assert _rel(got[0], ref) < 1e-12 and _rel(got[1], 2 * ref) < 1e-12
    assert _rel(piso.iso_D(L), refs[2]) < 1e-12
    assert _rel(piso.iso(torch.as_tensor(H)).numpy(), refs[3]) == 0


@pytest.mark.parametrize("n", [2, 3])
def test_open_system_matches_jax(n):
    """liouvillian, liouvillian_iso, compact_lindbladian and lindblad_rhs
    at random controls to 1e-12; the compact Lindbladian propagates the
    compact iso as the master equation does."""
    sp, sj, rng = _systems(n, 30 + n)
    u = rng.uniform(-1, 1, 2)
    ut = torch.as_tensor(u)
    rho = _density(rng, (), n)
    ub = rng.uniform(-1, 1, (4, 2))
    jS, jL, jA, jrhs, jSb = _j(lambda u, rho, ub: (
        jdyn.liouvillian(sj, u), sj.liouvillian_iso(u), sj.compact_lindbladian(u),
        sj.lindblad_rhs(rho, u), jax.vmap(lambda v: jdyn.liouvillian(sj, v))(ub)),
        u, rho, ub)
    S = pdyn.liouvillian(sp, ut).numpy()
    assert _rel(S, jS) < 1e-12
    assert _rel(sp.liouvillian_iso(ut).numpy(), jL) < 1e-12
    A = sp.compact_lindbladian(ut).numpy()
    assert _rel(A, jA) < 1e-12
    rhs = sp.lindblad_rhs(torch.as_tensor(rho), ut).numpy()
    assert _rel(rhs, jrhs) < 1e-12
    assert _rel(A @ piso.density_to_compact_iso(rho),
                piso.density_to_compact_iso(rhs)) < 1e-12
    assert _rel(S @ rho.T.reshape(-1), rhs.T.reshape(-1)) < 1e-12
    # batched controls give each knot's superoperator
    assert _rel(pdyn.liouvillian(sp, torch.as_tensor(ub)).numpy(), jSb) < 1e-12
    assert sp.dissipators[1].operator().shape == (n, n)
    # a closed system's Liouvillian is the commutator alone
    closed = pt.QuantumSystem(sp.H_drift, sp.H_drives, 1.0)
    assert _rel(pdyn.liouvillian(closed, ut).numpy(),
                -1j * piso.ad_vec(closed.H(ut).numpy())) < 1e-15


@pytest.mark.parametrize("n", [2, 3])
def test_solver_view_matches_jax(n):
    """The solver view's lind_drift, lind_drives, diss_mats and diss_rates
    equal piccolax's to 1e-12; its compact_lindbladian equals the
    system's, batched over knots and over a batched drift."""
    sp, sj, rng = _systems(n, 40 + n)
    u = rng.uniform(-1, 1, (3, 2))
    vj, jA = _j(lambda u: (sj.solver_view(),
                           jax.vmap(sj.solver_view().compact_lindbladian)(u)), u)
    vp = sp.solver_view()
    assert _rel(vp.lind_drift.numpy(), vj.lind_drift[0]) < 1e-12
    assert _rel(vp.lind_drives.numpy(), np.stack(vj.lind_drives)) < 1e-12
    assert _rel(vp.diss_mats.numpy(), np.stack(vj.diss_mats)) < 1e-12
    assert np.array_equal(vp.diss_rates.numpy(), np.stack(vj.diss_rates))
    assert _rel(vp.G_drift.numpy(), vj.drift_terms[0].H) < 1e-15
    A = vp.compact_lindbladian(torch.as_tensor(u)).numpy()
    assert _rel(A, jA) < 1e-12
    assert _rel(A, sp.compact_lindbladian(torch.as_tensor(u)).numpy()) < 1e-12
    v32 = vp.to(dtype=torch.float32)
    assert v32.lind_drives.dtype == v32.diss_rates.dtype == torch.float32
    # a batched drift [B, w, w] against u [B, K, d]
    dA = torch.as_tensor(rng.standard_normal((2, n * n, n * n)))
    vb = psys.RealGeneratorSystem(vp.G_drift, vp.G_drives, n,
                                  lind_drift=vp.lind_drift + dA,
                                  lind_drives=vp.lind_drives, diss_mats=vp.diss_mats,
                                  diss_rates=vp.diss_rates)
    ub = torch.as_tensor(rng.uniform(-1, 1, (2, 3, 2)))
    Ab = vb.compact_lindbladian(ub)
    assert _rel(Ab[1, 2].numpy(), (vp.compact_lindbladian(ub[1, 2]) + dA[1]).numpy()) < 1e-12
    with pytest.raises(ValueError):
        pt.QuantumSystem(sp.H_drift, sp.H_drives).solver_view().compact_lindbladian(ub)
    with pytest.raises(NotImplementedError):
        psys.NonlinearDissipator(np.eye(n), lambda u: 1.0)


def test_density_fidelities_match_jax():
    """density_fidelity (tr(rho rho_goal)) and density_fidelity_iso (the
    plain dot of compact isos, as piccolax computes it) to 1e-12. For a
    goal with off-diagonal entries the dot is not tr(rho rho_goal): the
    compact iso carries no sqrt(2) on the off-diagonal entries; the port
    gives piccolax's value."""
    rng = np.random.default_rng(50)
    rho = _density(rng, (4,), 3)
    goal = _density(rng, (), 3)
    x, g = piso.density_to_compact_iso(rho), piso.density_to_compact_iso(goal)
    jF, jFi = _j(lambda r, gl, x, g: (jdyn.density_fidelity(r, gl),
                                      jdyn.density_fidelity_iso(x, g)), rho, goal, x, g)
    F = pdyn.density_fidelity(torch.as_tensor(rho), goal).numpy()
    assert _rel(F, jF) < 1e-12
    Fi = pdyn.density_fidelity_iso(torch.as_tensor(x), torch.as_tensor(g)).numpy()
    assert _rel(Fi, jFi) < 1e-12
    assert np.max(np.abs(Fi - F)) > 1e-3
    # on a diagonal goal the dot is the trace fidelity
    diag = np.diag([0.2, 0.5, 0.3]).astype(complex)
    Fd = pdyn.density_fidelity_iso(torch.as_tensor(x),
                                   torch.as_tensor(piso.density_to_compact_iso(diag)))
    assert _rel(Fd.numpy(), np.einsum("bij,ji->b", rho, diag).real) < 1e-12


@pytest.mark.parametrize("n_substeps", [1, 4])
def test_density_rollout_matches_jax(n_substeps):
    """density_rollout of config 5's system (3-level transmon, decay
    sqrt(0.01) a) under a random ZOH pulse at N = 11, T = 2, to 1e-12;
    batched over two pulses; one K5 launch on the CPU plain version (no
    kernel); DensityTrajectory's rollout and fidelity."""
    rng = np.random.default_rng(60 + n_substeps)
    N, T = 11, 2.0
    base = pt.TransmonSystem(levels=3, drive_bounds=0.2)
    a = pt.quantum.operators.annihilate(3)
    sp = psys.OpenQuantumSystem(base.H_drift, base.H_drives, 0.2,
                                dissipators=[psys.LinearDissipator(a, 0.01)])
    sj = jsys.OpenQuantumSystem(base.H_drift, base.H_drives, 0.2,
                                dissipators=[jsys.LinearDissipator(a, 0.01)])
    times = np.linspace(0.0, T, N)
    us = 0.2 * rng.uniform(-1, 1, (2, N, 2))
    rho0 = np.diag([1.0, 0, 0]).astype(complex)
    _kernels.reset_launch_counts()
    got = pdyn.density_rollout(sp, pt.ZeroOrderPulse(torch.as_tensor(us),
                                                     np.tile(times, (2, 1))),
                               np.tile(times, (2, 1)), rho0, n_substeps, device="cpu")
    assert all(v == 0 for v in _kernels.LAUNCHES.values())
    assert got.shape == (2, N, 3, 3)
    ref = _j(jax.vmap(lambda v: jdyn.density_rollout(sj, JZOH(v, times), times, rho0,
                                                     n_substeps=n_substeps)), us)
    assert _rel(got.numpy(), ref) < 1e-12
    qt = pt.DensityTrajectory(sp, pt.ZeroOrderPulse(us[0], times), rho0,
                              np.diag([0, 1.0, 0]), n_substeps=n_substeps, device="cpu")
    assert _rel(qt.rhos.numpy(), got[0].numpy()) < 1e-15
    assert abs(qt.fidelity().item() - got[0, -1, 1, 1].real.item()) < 1e-15
    again = qt.rollout()
    assert again.n_substeps == n_substeps and _rel(again.rhos.numpy(), qt.rhos.numpy()) == 0
    assert _rel(qt.state_iso(times), piso.density_to_compact_iso(got[0].numpy())) < 1e-15


@pytest.mark.parametrize("n", [4, 9])
def test_nonnormal_expm_inputs_match_jax(n):
    """lindblad_by_squarings (the non-normal inputs on which chip_smoke.py
    holds K5): every squaring count 0..16, non-normal, and the plain K5
    (expm_plain) on them equals piccolax's expm to 1e-12 relative times
    2^(s-6) above s = 6, with finite values everywhere."""
    A = pexpm.lindblad_by_squarings(139, n, np.random.default_rng(70 + n))
    At = torch.as_tensor(A)
    s = pexpm.pade13_squarings(At)
    assert set(s.tolist()) == set(range(17))
    assert np.abs(A @ np.conj(np.swapaxes(A, -1, -2))
                  - np.conj(np.swapaxes(A, -1, -2)) @ A).max(axis=(-2, -1)).min() > 0
    got = pexpm.expm_plain(At).numpy()
    ref = _j(jax_expm, A)
    assert np.all(np.isfinite(got))
    rel = np.abs(got - ref).max(axis=(-2, -1)) / np.abs(ref).max(axis=(-2, -1))
    assert np.all(rel <= 1e-12 * 2.0 ** np.maximum(s.numpy() - 6, 0))
