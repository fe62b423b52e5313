"""The building blocks of globals in the port against piccolax, on the
CPU in float64: the free-phase angles, diagonals and row phases, the
free-phase objective, rollout fidelities at given phases, trajectory and
layout globals, the CNOT template's global options, and the ket
constraints that still raise. At most 9 tests a file (pytest-xdist's
loadfile schedule hands out files with more tests first, ahead of the
Tier-1 run's long pole); the KKT pieces of the constraints are in
tests/test_torch_globals.py, the solves in
tests/test_torch_globals_solve.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import piccolax as px  # noqa: E402
from piccolax import benchmarks as jbm  # noqa: E402
from piccolax.control import objectives as jobj  # noqa: E402
from piccolax.quantum import dynamics as jdyn  # noqa: E402
from piccolax.quantum import isomorphisms as jiso  # noqa: E402
import piccolax_torch as pt  # noqa: E402
from piccolax_torch.control import constraints as pcons  # noqa: E402
from piccolax_torch.control import objectives as pobj  # noqa: E402
from piccolax_torch.quantum import dynamics as pdyn  # noqa: E402
from piccolax_torch.quantum import isomorphisms as piso  # noqa: E402


def test_free_phase_angles_match_jax():
    """free_phase_angles and free_phase_diagonal over qubit counts and
    dims (one short of 2^n), free_phase_angles_levels over subsystem
    levels, against piccolax to 1e-12."""
    for nq, dim in ((1, 2), (2, 4), (3, 8), (2, 3)):
        ph = np.random.default_rng(nq + dim).standard_normal(nq)
        for f in ("free_phase_angles", "free_phase_diagonal"):
            a = getattr(pdyn, f)(torch.as_tensor(ph), nq, dim).numpy()
            b = np.asarray(getattr(jdyn, f)(jnp.asarray(ph), nq, dim))
            assert np.abs(a - b).max() < 1e-12, (f, nq, dim)
    for levels in ((2, 2), (3, 2), (2, 3, 4)):
        ph = np.random.default_rng(len(levels)).standard_normal(len(levels))
        dim = int(np.prod(levels))
        a = pdyn.free_phase_angles_levels(torch.as_tensor(ph), levels, dim).numpy()
        b = np.asarray(jdyn.free_phase_angles_levels(jnp.asarray(ph), levels, dim))
        assert np.abs(a - b).max() < 1e-12, levels


def test_row_phase_iso_matches_jax_batched():
    """apply_row_phase_iso on a batch of operator iso-vecs with a batch of
    angles is piccolax's, one problem at a time."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 32))
    th = rng.standard_normal((3, 1, 4))
    got = piso.apply_row_phase_iso(torch.as_tensor(x), torch.cos(torch.as_tensor(th)),
                                   torch.sin(torch.as_tensor(th))).numpy()
    for b in range(3):
        ref = np.asarray(jiso.apply_row_phase_iso(jnp.asarray(x[b]), jnp.cos(th[b, 0]),
                                                  jnp.sin(th[b, 0])))
        assert np.abs(got[b] - ref).max() < 1e-12


@pytest.mark.parametrize("subspace", [None, [0, 1]])
def test_free_phase_objective_matches_jax(subspace):
    """UnitaryFreePhaseInfidelityObjective at the last knot, batched over
    two phases, against piccolax's stage_cost (with and without an
    embedded goal)."""
    rng = np.random.default_rng(1)
    n = 3 if subspace else 2
    x = rng.standard_normal((2, 2 * n * n))
    goal = rng.standard_normal(2 * n * n)
    th = rng.standard_normal((2, 1))
    jo = jobj.UnitaryFreePhaseInfidelityObjective("U", "theta", 1, Q=7.0, subspace=subspace,
                                                  gview=lambda g: g)
    po = pobj.UnitaryFreePhaseInfidelityObjective("U", "theta", 1, Q=7.0, subspace=subspace)
    got = po.knot_cost(lambda nm: torch.as_tensor(x), torch.ones(2),
                       {"goal": {"U": torch.as_tensor(goal)}},
                       gview=lambda nm: torch.as_tensor(th)).numpy()
    for b in range(2):
        ref = float(jo.stage_cost(4, lambda nm: jnp.asarray(x[b]), jnp.asarray(th[b]),
                                  {"goal": {"U": jnp.asarray(goal)}}, 5))
        assert abs(got[b] - ref) < 1e-12 * max(abs(ref), 1.0)


@pytest.mark.parametrize("embedded", [False, True])
def test_rollout_fidelity_with_phases_matches_jax(embedded):
    """unitary_rollout_fidelity(phases=, n_qubits=) and
    UnitaryTrajectory.fidelity(phases) against piccolax."""
    rng = np.random.default_rng(2)
    times = np.linspace(0, 3.0, 9)
    us = 0.3 * rng.standard_normal((9, 2))
    if embedded:
        jsys = px.quantum.templates.TransmonSystem(levels=3, omega=4.0, delta=0.2,
                                                   drive_bounds=0.2)
        psys = pt.TransmonSystem(levels=3, omega=4.0, delta=0.2, drive_bounds=0.2)
        jgoal = px.EmbeddedOperator(px.GATES["X"], [0, 1], [3])
        pgoal = pt.EmbeddedOperator(pt.GATES["X"], [0, 1], [3])
        ph, nq = np.array([0.4]), 1
    else:
        H = [px.PAULIS["X"] / 2, px.PAULIS["Y"] / 2]
        jsys = px.QuantumSystem(np.zeros((2, 2)), H, 1.0)
        psys = pt.QuantumSystem(np.zeros((2, 2)), [np.asarray(h) for h in H], 1.0)
        jgoal = pgoal = np.asarray(px.GATES["SX"])
        ph, nq = np.array([0.4]), 1
    if embedded:
        ref = float(jdyn.unitary_rollout_fidelity(jsys, us, times, jgoal,
                                                  interpolation="constant",
                                                  phases=ph, n_qubits=nq))
        got = float(pt.unitary_rollout_fidelity(psys, us, times, pgoal,
                                                interpolation="constant", phases=ph,
                                                n_qubits=nq, device="cpu"))
        assert abs(got - ref) < 1e-12
    jtr = px.UnitaryTrajectory(jsys, px.ZeroOrderPulse(us, times), jgoal)
    ptr = pt.UnitaryTrajectory(psys, pt.ZeroOrderPulse(us, times), pgoal, device="cpu")
    assert abs(float(ptr.fidelity(ph, nq)) - float(jtr.fidelity(ph, nq))) < 1e-12
    assert abs(float(ptr.fidelity(ph)) - float(jtr.fidelity(ph))) < 1e-12


# -- trajectory and templates ------------------------------------------------------


def test_trajectory_globals_match_jax():
    """global_data and global_bounds, update_bound on a global, layout's
    global slices and gview, global_vector and with_knot_matrix(Z, g)."""
    rng = np.random.default_rng(4)
    data = {"x": rng.standard_normal((5, 3)), "u": rng.standard_normal((5, 2))}
    gd = {"a": [0.5], "b": rng.standard_normal(2)}
    trs = [pkg.Trajectory(data, controls=("u",), timestep=0.1, global_data=gd,
                          global_bounds={"a": 2.0}) for pkg in (px, pt)]
    trs = [t.update_bound("b", (-1.0, 1.0)) for t in trs]
    jt, ptr = trs
    assert ptr.global_names == jt.global_names and ptr.global_dim == jt.global_dim == 3
    for k in ("a", "b"):
        assert np.array_equal(ptr.global_bounds[k], np.asarray(jt.global_bounds[k]))
    jl, pl = jt.layout(), ptr.layout()
    assert pl.global_slices == jl.global_slices and pl.g_dim == jl.g_dim
    g = rng.standard_normal(3)
    assert np.array_equal(pl.gview(torch.as_tensor(g), "b").numpy(), np.asarray(
        jl.gview(jnp.asarray(g), "b")))
    assert np.array_equal(ptr.global_vector(), np.asarray(jt.global_vector()))
    Z = rng.standard_normal((5, 5))
    jn, pn = jt.with_knot_matrix(jnp.asarray(Z), jnp.asarray(g)), ptr.with_knot_matrix(Z, g)
    for k in ("a", "b"):
        assert np.array_equal(pn[k], np.asarray(jn[k]))
    assert np.array_equal(pn.knot_matrix(), np.asarray(jn.knot_matrix()))


def test_cnot_template_options_match_jax():
    """cnot_problem(N=12) with the template's global options: piccolax's
    dims, bounds of the globals, Z0 (geodesic off with a free phase) and
    g0."""
    for kw, dims in ((dict(free_phase=True), (44, 2, 40, 0)),
                     (dict(free_phase=True, calibration_targets={"theta": [0.0, 0.0]}),
                      (44, 2, 40, 2)),
                     (dict(free_phase=2, global_bounds={"theta": 0.5}), (44, 2, 40, 0))):
        jn, _, jZ0, jg0, _ = jbm.cnot_problem(N=12, T=3.0, **kw).build()
        n, _, Z0, g0, _ = pt.cnot_problem(N=12, T=3.0, device="cpu", **kw).build(
            device="cpu")
        assert (n.dz, n.dg, n.md, n.me) == (jn.dz, jn.dg, jn.md, jn.me) == dims
        assert np.array_equal(n.g_lo.numpy(), np.asarray(jn.g_lo))
        assert np.array_equal(n.g_hi.numpy(), np.asarray(jn.g_hi))
        assert np.abs(Z0.numpy() - np.asarray(jZ0)).max() < 1e-12
        assert np.array_equal(g0.numpy(), np.asarray(jg0))


def test_ket_constraints_wait_for_ket_trajectories():
    for cls in ("FinalKetFidelityConstraint", "FinalCoherentKetFidelityConstraint"):
        with pytest.raises(NotImplementedError):
            getattr(pcons, cls)("psi", 0.9)
