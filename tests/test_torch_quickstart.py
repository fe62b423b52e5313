"""The quickstart flow (docs/quickstart.py steps 1-5) at a reduced size
(N = 18, T = 3), in the port and in piccolax, on the CPU in float64: the
free-timestep build, its exact derivatives, the exact-Newton candidate's
first iterates, and solve -> fidelity -> extract_pulse end to end."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import piccolax as px  # noqa: E402
from piccolax.control import problem as jproblem  # noqa: E402
from piccolax.control.integrators import TimeStepsEqualIntegrator as JTSE  # noqa: E402
from piccolax.solver import ipm as jipm  # noqa: E402
from piccolax.solver.nlp import nlp_constraint_residuals as jres  # noqa: E402
import piccolax_torch as pt  # noqa: E402
from piccolax_torch import _kernels  # noqa: E402
from piccolax_torch.control import integrators as pint  # noqa: E402
from piccolax_torch.solver import ipm as pipm  # noqa: E402

N, T, B = 18, 3.0, 2
DT_BOUNDS = (0.05, 0.2)


def _quickstart(mod, **kw):
    sysm = mod.QuantumSystem(0.5 * mod.PAULIS["Z"],
                             [mod.PAULIS["X"], mod.PAULIS["Y"]], 1.0)
    times = np.linspace(0.0, T, N)
    pulse = mod.ZeroOrderPulse(
        0.1 * np.random.default_rng(0).standard_normal((N, 2)), times)
    qtraj = mod.UnitaryTrajectory(sysm, pulse, mod.GATES["X"], **kw)
    return sysm, mod.SmoothPulseProblem(qtraj, N, Q=100.0, R=1e-2, ddu_bound=1.0,
                                        dt_bounds=DT_BOUNDS)


def _jax_arrays(jqcp):
    """The arrays of a piccolax build, in the format of piccolax_torch.convert."""
    nlp, params, Z0, _, layout = jqcp.build()
    sysv = params["system"]
    bil = jqcp.integrators[0]
    regs = {o.name: o.R for o in jqcp.objectives if hasattr(o, "R")}
    u = bil.drive_name
    return {
        "Z0": np.asarray(Z0), "lo": np.asarray(nlp.lo), "hi": np.asarray(nlp.hi),
        "pin_mask": np.asarray(nlp.pin_mask),
        "pin_val": np.asarray(params["pin_val"]),
        "t": np.asarray(params["frozen"]["t"])[:, 0],
        "G_drift": np.asarray(sysv.drift_terms[0].H),
        "G_drives": np.stack([np.asarray(d.H) for d in sysv.drive_terms]),
        "goal": np.asarray(params["goal"][bil.state_name]),
        "Q": jqcp.objectives[0].Q,
        "R": [regs.get(n, 0.0) for n in (u, "d" + u, "dd" + u)],
        "slices": {n: (s.start, s.stop) for n, s in layout.slices.items()},
        "state_name": bil.state_name, "drive_name": u,
        "squarings": bil.squarings,
        "timesteps_all_equal": any(isinstance(i, JTSE) for i in jqcp.integrators),
    }


@pytest.fixture(scope="module")
def built():
    """Both builds; the batch holds the quickstart's own start Z0 and Z0
    with its pulse perturbed by 0.02 N(0, 1)."""
    jsys, jqcp = _quickstart(px)
    psys, qcp = _quickstart(pt, device="cpu")
    jnlp, jparams, jZ0, jg0, jlay = jqcp.build()
    nlp, params, Z0, _, lay = qcp.build(device="cpu")
    rng = np.random.default_rng(7)
    Zb = np.repeat(np.asarray(jZ0)[None], B, 0)
    u = jlay.slices["u"]
    Zb[1, :, u] += 0.02 * rng.standard_normal((N, u.stop - u.start))
    return dict(jsys=jsys, jqcp=jqcp, psys=psys, qcp=qcp, jnlp=jnlp,
                jparams=jparams, jg0=jg0, jlay=jlay, nlp=nlp, params=params,
                Z0=Z0, layout=lay, Zb=Zb, rng=rng, arrays=_jax_arrays(jqcp))


OPTS = dict(max_iter=150, tol=1e-7, constr_viol_tol=1e-7)
N_FIRST = 5
_HIST = ("Z", "lam", "mu", "delta_used")


@pytest.fixture(scope="module")
def jax_ref(built):
    """piccolax's IPM on both problems of the batch as a vmapped
    while_loop (its own setup and body, one compile), keeping the first
    N_FIRST iterates: (history {name: [B, N_FIRST, ...]}, final state)."""
    p = built
    opts = jipm.IPMOptions(**OPTS)

    def run(Z0):
        st, body = jipm._setup(p["jnlp"], p["jparams"], Z0, None, opts)
        hist = {k: jnp.zeros((N_FIRST,) + jnp.shape(getattr(st, k)),
                             jnp.result_type(getattr(st, k))) for k in _HIST}

        def cond(c):
            s = c[0]
            return (s.it < opts.max_iter) & ~(s.converged | s.stalled)

        def step(c):
            s, h = c
            s = body(s)
            slot = jnp.minimum(s.it - 1, N_FIRST - 1)
            h = {k: jnp.where(s.it <= N_FIRST, h[k].at[slot].set(getattr(s, k)),
                              h[k]) for k in _HIST}
            return s, h

        s, h = jax.lax.while_loop(cond, step, (st, hist))
        return h, s

    hist, final = jax.jit(jax.vmap(run))(jnp.asarray(p["Zb"]))
    return {k: np.asarray(v) for k, v in hist.items()}, final


@pytest.mark.parametrize("key", ["Z0", "lo", "hi", "pin_mask", "pin_val"])
def test_free_dt_build_matches_jax(built, key):
    """dz = 15 (U 8, u 2, dt 1, du 2, ddu 2), m = 13, dt free in
    [0.05, 0.2] and unpinned at every knot, t frozen."""
    p = built
    got = {"Z0": p["Z0"], "lo": p["nlp"].lo, "hi": p["nlp"].hi,
           "pin_mask": p["nlp"].pin_mask, "pin_val": p["params"]["pin_val"]}[key]
    a, b = got.numpy(), p["arrays"][key]
    assert a.shape == b.shape == (N, 15)
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    fin = np.isfinite(b)
    assert np.all(a[~fin] == b[~fin])
    assert np.max(np.abs(a[fin] - b[fin]), initial=0.0) < 1e-12


def test_free_dt_layout_matches_jax(built):
    p = built
    a = p["arrays"]
    assert {n: (s.start, s.stop) for n, s in p["layout"].slices.items()} == a["slices"]
    assert a["slices"]["dt"] == (10, 11) and p["nlp"].m == 13
    assert p["qcp"].integrators[0].squarings == a["squarings"] == 1
    assert isinstance(p["qcp"].integrators[-1], pint.TimeStepsEqualIntegrator)
    assert a["timesteps_all_equal"]
    assert list(p["params"]["frozen"]) == ["t"]
    assert np.max(np.abs(p["params"]["frozen"]["t"][:, 0].numpy() - a["t"])) < 1e-12
    assert p["nlp"].pin_mask[:, 10].sum() == 0


def test_free_dt_derivatives_match_jax(built):
    """Residuals, Cself, Cnext and Hext at a perturbed Z0 with random
    multipliers, including the dt column and the (dt, u), (dt, du) and
    (dt, U) Hessian entries."""
    p = built
    Z = p["Zb"][0]
    lam = p["rng"].standard_normal((N, 13))
    c_ref, (Cs, Cn, _), H = jax.jit(lambda Zj, lj: (
        jres(p["jnlp"], Zj, p["jg0"], p["jparams"]),
        jipm._jacobians(p["jnlp"], Zj, p["jg0"], p["jparams"]),
        jipm._stage_hessians_split(p["jnlp"], Zj, p["jg0"], p["jparams"], lj)))(
            jnp.asarray(Z), jnp.asarray(lam))
    Zt = torch.as_tensor(Z)
    c = pt.solver.nlp_constraint_residuals(p["nlp"], Zt, None, p["params"])
    _, pCs, pCn, pH = pipm._derivatives(p["nlp"], Zt, p["params"],
                                        torch.as_tensor(lam))
    H = np.asarray(H)
    assert np.max(np.abs(c.numpy() - np.asarray(c_ref))) < 1e-10
    assert np.max(np.abs(pCs.numpy() - np.asarray(Cs))) < 1e-10
    assert np.max(np.abs(pCn.numpy() - np.asarray(Cn))) < 1e-10
    assert np.max(np.abs(pH.numpy() - H)) < 1e-10 * np.abs(H).max()
    dt, u, du = 10, slice(8, 10), slice(11, 13)
    assert np.abs(np.asarray(Cs)[:-1, :, dt]).min(axis=0).max() > 0
    assert np.abs(H[:-1, dt, u]).min() > 0 and np.abs(H[:-1, dt, du]).min() > 0
    assert np.abs(H[:-1, dt, :8]).max() > 0


def test_nlp_from_jax_arrays_matches_own_build(built):
    p = built
    nlp2, params2, Z02, _, _ = pt.nlp_from_numpy(p["arrays"], device="cpu")
    assert torch.equal(p["Z0"], Z02)
    Z = torch.as_tensor(p["Zb"])
    lam = torch.as_tensor(p["rng"].standard_normal((B, N, 13)))
    for f in (lambda n, q: pt.solver.nlp_constraint_residuals(n, Z, None, q),
              lambda n, q: pt.solver.nlp_total_cost(n, Z, None, q),
              lambda n, q: pipm._derivatives(n, Z, q, lam)[3]):
        assert torch.allclose(f(p["nlp"], p["params"]), f(nlp2, params2),
                              rtol=0, atol=1e-12)


def test_newton_candidate_first_iterates_match_jax(built, jax_ref):
    """B = 2 with newton_dir at its float64 default on both sides: the
    first iterations, Z, lam and mu to 1e-8 relative and the same
    candidate picked (delta_used) at every iteration."""
    p = built
    hist, _ = jax_ref
    state, body = pipm._setup(p["nlp"], p["params"], torch.as_tensor(p["Zb"]),
                              None, pipm.IPMOptions(**OPTS))
    codes = set()
    for it in range(N_FIRST):
        state = body(state)
        for name in ("Z", "lam", "mu"):
            a = getattr(state, name).numpy()
            b = hist[name][:, it]
            assert np.max(np.abs(a - b)) <= 1e-8 * max(np.abs(b).max(), 1e-300), \
                (it, name)
        d = state.delta_used.numpy()
        assert np.array_equal(d, hist["delta_used"][:, it]), it
        codes |= set(d.tolist())
    assert any(c % 100 >= 10 for c in codes)      # Newton factored at least once


@pytest.fixture(scope="module")
def solved(built, jax_ref):
    """The quickstart's solve -> sync in both: piccolax's from problem 0 of
    the vmapped reference (its own writeback and sync), the port's by
    qcp.solve()."""
    p = built
    final = jax.tree_util.tree_map(lambda x: x[0], jax_ref[1])
    jq = p["jqcp"]
    jq.result = final
    jq.traj = jproblem._writeback(jq.traj, p["jlay"], final.Z, final.g)
    jq.sync_trajectory()
    _kernels.reset_launch_counts()
    p["qcp"].solve(max_iter=150, tol=1e-7, verbose=False, device="cpu")
    return p


def test_quickstart_solve_matches_jax(solved):
    """solve() -> fidelity() to 1e-6 of piccolax, equal converged flags,
    and the quickstart's own bar: the independent rollout (10 substeps)
    agrees to 1e-5."""
    p = solved
    jq, q = p["jqcp"], p["qcp"]
    assert all(v == 0 for v in _kernels.LAUNCHES.values())
    assert q.converged == jq.converged
    assert q.stalled == jq.stalled
    F, F_ref = float(q.fidelity()), float(jq.fidelity())
    assert abs(F - F_ref) < 1e-6
    assert F > 0.99
    tt = q.traj.get_times()
    F_roll = float(pt.unitary_rollout_fidelity(
        p["psys"], q.traj["u"], tt, pt.GATES["X"], interpolation="constant",
        device="cpu"))
    assert abs(F - F_roll) < 1e-5


def test_extract_pulse_matches_jax(solved):
    p = solved
    jpulse = px.extract_pulse(p["jqcp"].qtraj, p["jqcp"].traj)
    pulse = pt.extract_pulse(p["qcp"].qtraj, p["qcp"].traj)
    assert np.max(np.abs(pulse.values - np.asarray(jpulse.values))) < 1e-8
    assert np.max(np.abs(pulse.times - np.asarray(jpulse.times))) < 1e-8
    assert np.max(np.abs(p["qcp"].pulse.values - pulse.values)) == 0.0
    dts = np.diff(pulse.times)
    assert np.all(dts >= DT_BOUNDS[0] - 1e-6) and np.all(dts <= DT_BOUNDS[1] + 1e-6)
    assert np.max(dts) - np.min(dts) < 1e-8             # timesteps held equal


def test_solve_never_falls_back_to_the_cpu(built):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, qcp = _quickstart(pt, device="cpu")
    with pytest.raises(RuntimeError):
        qcp.solve(max_iter=2, verbose=False)


@pytest.mark.parametrize("kw", [dict(verbose="detailed")])
def test_unported_solve_arguments_raise(built, kw):
    with pytest.raises(NotImplementedError):
        built["qcp"].solve(max_iter=1, device="cpu", **kw)


@pytest.mark.parametrize("lower", [0.0, -0.1])
def test_free_dt_needs_a_positive_lower_bound(lower):
    """The (dt, u) Hessian entries divide by dt, so a lower end at or
    below 0 is refused when the problem is built."""
    sysm = pt.QuantumSystem(0.5 * pt.PAULIS["Z"], [pt.PAULIS["X"], pt.PAULIS["Y"]], 1.0)
    times = np.linspace(0.0, T, N)
    pulse = pt.ZeroOrderPulse(np.zeros((N, 2)), times)
    qtraj = pt.UnitaryTrajectory(sysm, pulse, pt.GATES["X"], device="cpu")
    with pytest.raises(ValueError, match="positive lower end"):
        pt.SmoothPulseProblem(qtraj, N, dt_bounds=(lower, 0.2))
