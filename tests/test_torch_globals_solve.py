"""Solves with globals and stage equalities in the port against piccolax,
on the CPU in float64 at N = 11-12: the free-phase SX gate (one phase
global), its calibration pin and global bounds, the qutrit X with a
leakage constraint (a slack a knot, me = 1), hess_mode "shift" with its
delta_w history, exact resume from the port's own and from piccolax's
checkpoint, the per-iteration callback, and a batch in which one
problem's factorization fails. Four JAX compilations shared by the file;
at most 9 tests (pytest-xdist's loadfile schedule hands out files with
more tests first). The building blocks are held in
tests/test_torch_globals.py."""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from piccolax import benchmarks as jbm  # noqa: E402
from piccolax.control.problem import _SOLVE as JSOLVE  # noqa: E402
from piccolax.quantum.operators import get_iso_vec_leakage_indices  # noqa: E402
from piccolax.solver import ipm as jipm  # noqa: E402
from piccolax.utils.checkpoint import save_solver_state as jsave  # noqa: E402
import piccolax_torch as pt  # noqa: E402
from piccolax_torch.utils import checkpoint as pck  # noqa: E402

N, T = 12, 4.0
SOLVE = dict(max_iter=150, tol=1e-7, constr_viol_tol=1e-7)
SHIFT = dict(max_iter=15, tol=1e-10, constr_viol_tol=1e-10, hess_mode="shift")
HIST = ("kkt", "mu", "alpha", "delta", "dw")


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _sx(pkg, **kw):
    dev = {} if pkg is jbm else {"device": "cpu"}
    return pkg.sx_gate_problem(N=N, T=T, free_phase=True, **dev, **kw)


@pytest.fixture(scope="module")
def fp():
    """The free-phase SX gate solved to its end in both packages (one
    JAX compilation, which the global-bounds test reuses)."""
    jq, pq = _sx(jbm), _sx(pt)
    jq.solve(verbose=False, **{k: SOLVE[k] for k in ("max_iter", "tol")})
    pq.solve(verbose=False, device="cpu", **{k: SOLVE[k] for k in ("max_iter", "tol")})
    return jq, pq


@pytest.fixture(scope="module")
def shift_ref():
    """piccolax's traced "shift" run of 15 iterations from the free-phase
    SX start: (final state, history, build)."""
    jnlp, jparams, jZ0, jg0, _ = _sx(jbm).build()
    st, hist = jax.jit(jipm.solve_nlp_traced, static_argnames=("options",))(
        jnlp, jparams, jZ0, jg0, options=jipm.IPMOptions(**SHIFT))
    return st, {k: np.asarray(v) for k, v in hist.items()}


@pytest.fixture(scope="module")
def pbuild():
    return _sx(pt).build(device="cpu")


def test_free_phase_sx_solve_matches_jax(fp):
    """free_phase=True: theta is a global (dg = 1, geodesic off); the
    solve to its end gives piccolax's iterations, Z, theta and the
    free-phase rollout fidelity to 1e-8."""
    jq, pq = fp
    assert pq.result.g.shape == (1,) and int(pq.result.it) == int(jq.result.it)
    assert bool(pq.converged) == bool(jq.result.converged)
    Zj = np.concatenate([np.asarray(jq.traj.data[n]) for n in jq.traj.names
                         if n not in jq.traj.frozen], axis=1)
    Zp = np.concatenate([pq.traj.data[n] for n in pq.traj.names
                         if n not in pq.traj.frozen], axis=1)
    assert _rel(Zp, Zj) < 1e-8
    assert np.abs(pq.traj.global_data["theta"]
                  - np.asarray(jq.traj.global_data["theta"])).max() < 1e-8
    assert abs(float(pq.fidelity()) - float(jq.fidelity())) < 1e-8
    assert float(pq.fidelity()) > 0.999


def test_global_bounds_hold_theta_as_jax(fp):
    """global_bounds={"theta": (0.05, 0.3)} keeps theta off its unbounded
    optimum (about 0): the port's build carries piccolax's g_lo/g_hi, and
    the solve gives piccolax's iterations, Z and theta to 1e-8 with theta
    inside the box (piccolax's run reuses the free-phase compilation)."""
    jnlp, jparams = fp[0].build()[:2]            # the solved problem's structure
    jZ0, jg0 = _sx(jbm).build()[2:4]             # and a fresh start
    pq = _sx(pt, global_bounds={"theta": (0.05, 0.3)})
    nlp, params, Z0, g0, _ = pq.build(device="cpu")
    assert nlp.g_lo.tolist() == [0.05] and nlp.g_hi.tolist() == [0.3]
    jst = JSOLVE(jnlp.replace(g_lo=jnp.asarray([0.05]), g_hi=jnp.asarray([0.3])),
                 jparams, jZ0, jg0, options=jipm.IPMOptions(**SOLVE),
                 callback=None, callback_every=1)
    st = pt.solve_nlp(nlp, params, Z0, g0, options=pt.IPMOptions(**SOLVE), device="cpu")
    assert int(st.it) == int(jst.it)
    assert _rel(st.Z.numpy(), np.asarray(jst.Z)) < 1e-8
    assert abs(float(st.g[0]) - float(jst.g[0])) < 1e-8
    assert 0.05 < float(st.g[0]) < 0.3


def test_calibration_target_pins_theta_as_jax():
    """calibration_targets={"theta": 0.2}: a GlobalPinConstraint row at
    the first knot (me = 1); 25 iterations give piccolax's Z, theta and
    lam to 1e-8, with theta on its target."""
    kw = dict(calibration_targets={"theta": 0.2})
    opts = dict(max_iter=25, tol=1e-10, constr_viol_tol=1e-10, newton_dir=False)
    jnlp, jparams, jZ0, jg0, _ = _sx(jbm, **kw).build()
    nlp, params, Z0, g0, _ = _sx(pt, **kw).build(device="cpu")
    assert (nlp.me, nlp.dg, nlp.m) == (jnlp.me, jnlp.dg, jnlp.m) == (1, 1, 1 + jnlp.md)
    jst = jax.jit(lambda Z, g: jipm.solve_nlp(jnlp, jparams, Z, g,
                                              jipm.IPMOptions(**opts)))(jZ0, jg0)
    st = pt.solve_nlp(nlp, params, Z0, g0, options=pt.IPMOptions(**opts), device="cpu")
    for name in ("Z", "g", "lam"):
        assert _rel(getattr(st, name).numpy(), np.asarray(getattr(jst, name))) < 1e-8, name
    assert abs(float(st.g[0]) - 0.2) < 1e-6


def test_leakage_value_qutrit_matches_jax():
    """qutrit_x_problem(leakage_value=1e-3): a LeakageConstraint with a
    slack a knot (dz = 25, md = 22, me = 1) beside the leakage cost; 20
    iterations ("abs") give piccolax's Z and lam to 1e-8 and the same
    knot leakage."""
    kw = dict(N=11, T=4.0, leakage_value=1e-3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")             # dt ||H|| > 1.5 at N = 11
        jnlp, jparams, jZ0, jg0, jl = jbm.qutrit_x_problem(**kw).build()
        nlp, params, Z0, g0, layout = pt.qutrit_x_problem(device="cpu", **kw).build(
            device="cpu")
    assert (nlp.dz, nlp.dg, nlp.md, nlp.me) == (jnlp.dz, jnlp.dg, jnlp.md, jnlp.me) \
        == (25, 0, 22, 1)
    assert layout.slices == jl.slices
    opts = dict(max_iter=20, tol=1e-10, constr_viol_tol=1e-10, newton_dir=False,
                hess_mode="abs")
    jst = jax.jit(lambda Z, g: jipm.solve_nlp(jnlp, jparams, Z, g,
                                              jipm.IPMOptions(**opts)))(jZ0, jg0)
    st = pt.solve_nlp(nlp, params, Z0, g0, options=pt.IPMOptions(**opts), device="cpu")
    assert _rel(st.Z.numpy(), np.asarray(jst.Z)) < 1e-8
    assert _rel(st.lam.numpy(), np.asarray(jst.lam)) < 1e-8
    leak = get_iso_vec_leakage_indices([0, 1], 3)
    U = st.Z.numpy()[:, layout.slices["U"]]
    Uj = np.asarray(jst.Z)[:, layout.slices["U"]]
    assert np.abs((U[:, leak] ** 2).sum(-1) - (Uj[:, leak] ** 2).sum(-1)).max() < 1e-10


def test_shift_iterates_and_dw_history_match_jax(shift_ref, pbuild):
    """hess_mode="shift" (one factorization of W + delta_w I, no clamp):
    solve_nlp_traced over 15 iterations gives piccolax's kkt, mu, alpha,
    direction codes and delta_w history and its final Z and theta to
    1e-8."""
    jst, jhist = shift_ref
    nlp, params, Z0, g0, _ = pbuild
    st, hist = pt.solve_nlp_traced(nlp, params, Z0, g0, device="cpu",
                                   options=pt.IPMOptions(**SHIFT))
    for k in HIST:
        assert hist[k].shape == (15,)
        assert _rel(hist[k].numpy(), jhist[k]) < 1e-8, k
    assert len(set(jhist["dw"].tolist())) > 2           # delta_w moved both ways
    assert _rel(st.Z.numpy(), np.asarray(jst.Z)) < 1e-8
    assert _rel(st.g.numpy(), np.asarray(jst.g)) < 1e-8


def test_resume_is_bit_exact_and_takes_jax_checkpoints(shift_ref, pbuild, tmp_path):
    """15 iterations, save_solver_state, load_solver_state, 25 resumed ==
    40 straight, bit for bit in Z, lam and g ("shift": delta_w and every
    counter travel in the checkpoint); piccolax's checkpoint of its 15
    iterations, resumed in the port for 25, gives the port's 40 to
    1e-10; the port's file has piccolax's keys."""
    nlp, params, Z0, g0, _ = pbuild

    def run(n, resume=None):
        o = pt.IPMOptions(**{**SHIFT, "max_iter": n})
        return pt.solve_nlp(nlp, params, Z0, g0, options=o, resume_from=resume,
                            device="cpu")

    full, part = run(40), run(15)
    path = str(tmp_path / "port.npz")
    pck.save_solver_state(path, part)
    restored = pck.load_solver_state(path, like=part)
    resumed = run(25, restored)
    assert int(part.it) == 15 and int(resumed.it) == 25
    for name in ("Z", "lam", "g"):
        assert torch.equal(getattr(resumed, name), getattr(full, name)), name
    jpath = str(tmp_path / "jax.npz")
    jsave(jpath, shift_ref[0])
    assert set(np.load(path).files) == set(np.load(jpath).files)
    from_jax = run(25, pck.load_solver_state(jpath))
    for name in ("Z", "lam", "g"):
        assert _rel(getattr(from_jax, name).numpy(), getattr(full, name).numpy()) \
            < 1e-10, name


def test_callback_sequence_matches_jax(shift_ref, pbuild):
    """callback(it, kkt_err, mu, alpha, Z) fires after each of the 15
    iterations with piccolax's history to 1e-8; QuantumControlProblem's
    hook gets the pulse [N, 2] every callback_every = 5 iterations."""
    _, jhist = shift_ref
    nlp, params, Z0, g0, _ = pbuild
    seen = []
    pt.solve_nlp(nlp, params, Z0, g0, device="cpu", options=pt.IPMOptions(**SHIFT),
                 callback=lambda it, kkt, mu, alpha, Z: seen.append(
                     (int(it), float(kkt), float(mu), float(alpha), tuple(Z.shape))))
    assert [s[0] for s in seen] == list(range(1, 16))
    assert all(s[4] == tuple(Z0.shape) for s in seen)
    for j, key in ((1, "kkt"), (2, "mu"), (3, "alpha")):
        assert _rel([s[j] for s in seen], jhist[key]) < 1e-8, key
    hook = []
    _sx(pt).solve(verbose=False, device="cpu", callback=lambda *a: hook.append(a),
                  callback_every=5, options=pt.IPMOptions(**SHIFT))
    assert [h[0] for h in hook] == [5, 10, 15] and hook[0][4].shape == (N, 2)


def test_failed_factorization_stays_in_its_problem(pbuild):
    """A batch of 3 free-phase problems whose middle one starts from NaN
    pulses (its factorizations fail, its Schur block of the globals is
    NaN): no error, its iterate stays NaN, and the other two equal their
    B = 1 solves to 1e-12 (the first is the solve held against piccolax
    above)."""
    nlp, params, Z0, g0, layout = pbuild
    u = layout.slices["u"]
    Zb = Z0.expand(3, *Z0.shape).clone()
    Zb[2, :, u] += 0.01 * torch.as_tensor(np.random.default_rng(0).standard_normal(
        (N, u.stop - u.start)))
    Zb[1, 3:6, u] = float("nan")
    o = pt.IPMOptions(**{**SOLVE, "max_iter": 20})
    st = pt.solve_nlp(nlp, params, Zb, g0, options=o, device="cpu")
    assert torch.isnan(st.Z[1]).any() and not st.converged[1]
    for b in (0, 2):
        one = pt.solve_nlp(nlp, params, Zb[b], g0, options=o, device="cpu")
        assert int(st.it[b]) == int(one.it)
        for name in ("Z", "g", "lam"):
            assert _rel(getattr(st, name)[b].numpy(), getattr(one, name).numpy()) \
                < 1e-12, (b, name)
