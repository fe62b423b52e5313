"""Globals, stage equalities and their building blocks in the port against
piccolax, on the CPU in float64 (no kernel is reached: the constraint
rows, the free-phase objective and the global regularizer go through
torch.func, the KKT's plain versions serve CPU tensors).

Three builds of each package share the file, one jitted JAX evaluation
each: the qutrit X (N = 11, T = 4) with a free phase, a calibration pin,
a global bound, the leakage constraint and every non-ket constraint
class beside it (me = 16, dg = 3); the free-phase SX gate with the two
final unitary fidelity constraints (no subspace); the Lindblad transfer
with a final density fidelity constraint. At a perturbed point each
group's rows and Jacobians (in z and in g), the lambda-weighted
Lagrangian Hessians over (z_k, g), the gradients and the cost are held
to 1e-10 (relative). At most 9 tests a file (pytest-xdist's loadfile
schedule hands out files with more tests first, ahead of the Tier-1 run's
long pole): the building blocks are in tests/test_torch_globals_parts.py,
the solves in tests/test_torch_globals_solve.py.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import piccolax as px  # noqa: E402
from piccolax import benchmarks as jbm  # noqa: E402
from piccolax.control import constraints as jcons  # noqa: E402
from piccolax.control import objectives as jobj  # noqa: E402
from piccolax.solver import ipm as jipm  # noqa: E402
from piccolax.solver.nlp import nlp_constraint_residuals as jres  # noqa: E402
from piccolax.solver.nlp import nlp_total_cost as jcost  # noqa: E402
from piccolax.utils import checkpoint as jck  # noqa: E402
import piccolax_torch as pt  # noqa: E402
from piccolax_torch.control import constraints as pcons  # noqa: E402
from piccolax_torch.control import objectives as pobj  # noqa: E402
from piccolax_torch.solver import ipm as pipm  # noqa: E402
from piccolax_torch.utils import checkpoint as pck  # noqa: E402

TOL = 1e-10


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _qutrit_kw(c, o):
    """Config 2 with every non-ket constraint class (package modules c, o)."""
    return dict(N=11, T=4.0, free_phase=True, leakage_value=1e-3,
                calibration_targets={"theta": 0.1}, global_bounds={"theta": (-1.0, 1.0)},
                extra_constraints=[
                    c.FinalUnitaryFidelityConstraint("U", 0.5, subspace=[0, 1]),
                    c.FinalUnitaryFreePhaseFidelityConstraint(
                        "U", 0.5, "theta", 1, subspace=[0, 1], slack_name="_fpf"),
                    c.L1SlackConstraint("u", 2),
                    c.BoundStateL2Constraint("U", c.iso_entry_pairs(18, 3)),
                    c.ComplexModulusConstraint("u", [(0, 1)], 0.2)])


def _builds():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")             # dt ||H|| > 1.5 at N = 11
        jq = jbm.qutrit_x_problem(**_qutrit_kw(jcons, jobj), extra_objectives=[
            jobj.GlobalRegularizer(lambda g: g[0:1], 0.5)])
        pq = pt.qutrit_x_problem(device="cpu", **_qutrit_kw(pcons, pobj),
                                 extra_objectives=[pobj.GlobalRegularizer("theta", 0.5)])
    sx = {}
    for pkg, c, dev in ((jbm, jcons, {}), (pt, pcons, {"device": "cpu"})):
        sx[pkg] = pkg.sx_gate_problem(N=11, T=4.0, free_phase=True, **dev, extra_constraints=[
            c.FinalUnitaryFidelityConstraint("U", 0.5),
            c.FinalUnitaryFreePhaseFidelityConstraint("U", 0.5, "theta", 1, slack_name="_fpf")])
    dens = {pkg: pkg.lindblad_problem(N=11, T=2.0, **dev, extra_constraints=[
        c.FinalDensityFidelityConstraint("rho", 0.5)])
        for pkg, c, dev in ((jbm, jcons, {}), (pt, pcons, {"device": "cpu"}))}
    return {"qutrit": (jq, pq), "sx": (sx[jbm], sx[pt]), "density": (dens[jbm], dens[pt])}


def _jax_pieces(jnlp, jparams, Z, g, lam):
    def f(Z, g, lam):
        gz, gg = jipm._gradients(jnlp, Z, g, jparams)
        Cs, Cn, Jg = jipm._jacobians(jnlp, Z, g, jparams)
        H = jipm._stage_hessians(jnlp, Z, g, jparams, lam)
        return dict(c=jres(jnlp, Z, g, jparams), f=jcost(jnlp, Z, g, jparams), gz=gz,
                    gg=gg, Cs=Cs, Cn=Cn, Jg=Jg, H=H)
    return {k: np.asarray(v) for k, v in jax.jit(f)(Z, g, lam).items()}


@pytest.fixture(scope="module")
def built():
    out = {}
    rng = np.random.default_rng(3)
    for name, (jq, pq) in _builds().items():
        jnlp, jparams, jZ0, jg0, jl = jq.build()
        nlp, params, Z0, g0, layout = pq.build(device="cpu")
        Z = np.asarray(jZ0) + 0.01 * rng.standard_normal(jZ0.shape)
        g = np.asarray(jg0) + 0.1 * rng.standard_normal(jg0.shape)
        lam = rng.standard_normal((jnlp.N, jnlp.m))
        ref = _jax_pieces(jnlp, jparams, jnp.asarray(Z), jnp.asarray(g), jnp.asarray(lam))
        T = {k: torch.as_tensor(v)[None] for k, v in (("Z", Z), ("g", g), ("lam", lam))}
        gz, gg, Cs, Cn, Jg, H = pipm._kkt_pieces(nlp, T["Z"], T["g"], params, T["lam"])
        got = dict(c=pt.solver.nlp_constraint_residuals(nlp, T["Z"], T["g"], params),
                   f=pt.solver.nlp_total_cost(nlp, T["Z"], T["g"], params),
                   gz=gz, gg=gg, Cs=Cs, Cn=Cn, Jg=Jg, H=H)
        got = {k: v[0].numpy() for k, v in got.items()}
        out[name] = dict(jnlp=jnlp, jl=jl, jZ0=jZ0, jg0=jg0, nlp=nlp, layout=layout,
                         Z0=Z0, g0=g0, ref=ref, got=got, jq=jq, pq=pq)
    return out


# -- builds ----------------------------------------------------------------------


@pytest.mark.parametrize("name,dims", [("qutrit", (39, 3, 22, 16)),
                                       ("sx", (14, 3, 12, 2)),
                                       ("density", (15, 1, 13, 1))])
def test_build_matches_jax(built, name, dims):
    """dz, dg, md, me, the layout's knot and global slices, Z0, g0, the
    bounds of Z and g and the equality rows' mask are piccolax's."""
    b = built[name]
    jn, n = b["jnlp"], b["nlp"]
    assert (n.dz, n.dg, n.md, n.me) == (jn.dz, jn.dg, jn.md, jn.me) == dims
    assert b["layout"].slices == b["jl"].slices
    assert b["layout"].global_slices == b["jl"].global_slices
    for k in ("lo", "hi", "g_lo", "g_hi", "eq_mask", "pin_mask"):
        assert np.array_equal(getattr(n, k).numpy(), np.asarray(getattr(jn, k))), k
    assert np.abs(b["Z0"].numpy() - np.asarray(b["jZ0"])).max() < 1e-12
    assert np.array_equal(b["g0"].numpy(), np.asarray(b["jg0"]))


# each build's constraint groups: (name, first row, rows)
GROUPS = {"qutrit": [("final unitary fidelity (subspace)", 0, 1),
                     ("final free-phase fidelity (subspace)", 1, 1), ("L1 slack", 2, 2),
                     ("bound state L2", 4, 9), ("complex modulus", 13, 1),
                     ("global pin", 14, 1), ("leakage", 15, 1)],
          "sx": [("final unitary fidelity", 0, 1), ("final free-phase fidelity", 1, 1)],
          "density": [("final density fidelity", 0, 1)]}


@pytest.mark.parametrize("name", ["qutrit", "sx", "density"])
def test_kkt_pieces_match_jax(built, name):
    """Each constraint group's masked rows and their Jacobians in z_k and
    in g (stacked ahead of the dynamics rows, nonzero); all rows [eq;
    dynamics] of Cself, Cnext, Jg and the residuals; the lambda-weighted
    Lagrangian Hessians over (z_k, g) (piccolax's `_stage_hessians`,
    unpermuted); the cost and its gradients in Z and in g (the free-phase
    objective, the global regularizer, the leakage cost)."""
    ref, got = built[name]["ref"], built[name]["got"]
    for what, r0, nr in GROUPS[name]:
        rows = slice(r0, r0 + nr)
        for k in ("c", "Cs", "Jg"):
            a, b = got[k][:, rows], ref[k][:, rows]
            assert np.abs(a - b).max() <= TOL * max(np.abs(b).max(), 1.0), (what, k)
        assert np.abs(ref["c"][:, rows]).max() > 0, what
    for k in ("c", "Cs", "Cn", "Jg", "H", "f", "gz", "gg"):
        assert got[k].shape == ref[k].shape, k
        assert _rel(got[k], ref[k]) < TOL, k


# -- convert, checkpoints ----------------------------------------------------------------


def _convert_arrays(jq, **extra):
    nlp, params, Z0, g0, layout = jq.build()
    sysv, bil = params["system"], jq.integrators[0]
    regs = {o.name: o.R for o in jq.objectives if hasattr(o, "R")}
    u = bil.drive_name
    return {
        "Z0": np.asarray(Z0), "lo": np.asarray(nlp.lo), "hi": np.asarray(nlp.hi),
        "pin_mask": np.asarray(nlp.pin_mask), "pin_val": np.asarray(params["pin_val"]),
        "t": np.asarray(params["frozen"]["t"])[:, 0],
        "dt": np.asarray(params["frozen"]["dt"])[:, 0],
        "G_drift": np.asarray(sysv.drift_terms[0].H),
        "G_drives": np.stack([np.asarray(d.H) for d in sysv.drive_terms]),
        "goal": np.asarray(params["goal"]["U"]), "Q": jq.objectives[0].Q,
        "R": [regs.get(n, 0.0) for n in (u, "d" + u, "dd" + u)],
        "slices": {n: (s.start, s.stop) for n, s in layout.slices.items()},
        "global_slices": {n: (s.start, s.stop) for n, s in layout.global_slices.items()},
        "g0": np.asarray(g0), "g_lo": np.asarray(nlp.g_lo), "g_hi": np.asarray(nlp.g_hi),
        "state_name": "U", "drive_name": u, "squarings": bil.squarings, **extra}


@pytest.mark.parametrize("case", ["sx", "qutrit"])
def test_convert_carries_globals_and_eq_rows(case):
    """nlp_from_numpy of piccolax's arrays with globals, g_lo/g_hi and
    equality rows (a calibration pin; on the qutrit also the leakage
    constraint and cost with the subspace) gives the port's own build:
    Z0 (to 1e-12: piccolax's rollout), g0 and the residuals, cost and KKT
    pieces at a perturbed point."""
    kw = dict(free_phase=True, calibration_targets={"theta": 0.1})
    extra = dict(free_phase=("theta", 1), calibration_targets={"theta": 0.1})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if case == "sx":
            jq = jbm.sx_gate_problem(N=11, T=4.0, global_bounds={"theta": 1.0}, **kw)
            pq = pt.sx_gate_problem(N=11, T=4.0, global_bounds={"theta": 1.0}, device="cpu",
                                    **kw)
        else:
            kw["leakage_value"] = 1e-3
            jq = jbm.qutrit_x_problem(N=11, T=4.0, **kw)
            pq = pt.qutrit_x_problem(N=11, T=4.0, device="cpu", **kw)
            leak = px.quantum.operators.get_iso_vec_leakage_indices([0, 1], 3)
            extra.update(subspace=[0, 1], leakage_indices=leak, leakage_cost=1.0,
                         leakage_value=1e-3)
    a = _convert_arrays(jq, **extra)
    n1, p1, Z1, g1, _ = pt.nlp_from_numpy(a, device="cpu")
    n2, p2, Z2, g2, _ = pq.build(device="cpu")
    assert torch.allclose(Z1, Z2, rtol=0, atol=1e-12) and torch.equal(g1, g2)
    assert (n1.me, n1.dg) == (n2.me, n2.dg)
    rng = np.random.default_rng(5)
    Z = torch.as_tensor(Z1.numpy() + 0.01 * rng.standard_normal(Z1.shape))[None]
    g = torch.as_tensor(g1.numpy() + 0.1 * rng.standard_normal(g1.shape))[None]
    lam = torch.as_tensor(rng.standard_normal((1, n1.N, n1.m)))
    for f in (lambda n, q: pt.solver.nlp_constraint_residuals(n, Z, g, q),
              lambda n, q: pt.solver.nlp_total_cost(n, Z, g, q),
              lambda n, q: pipm._kkt_pieces(n, Z, g, q, lam)[5],
              lambda n, q: pipm._kkt_pieces(n, Z, g, q, lam)[4]):
        assert torch.allclose(f(n1, p1), f(n2, p2), rtol=0, atol=1e-12)


def test_checkpoint_keys_round_trip_with_jax(built, tmp_path):
    """save_solver_state writes piccolax's keys; piccolax's load_pytree
    reads the port's file (one problem) and the port reads piccolax's,
    every leaf exact."""
    b = built["sx"]
    st = pt.solve_nlp(b["nlp"], pt.sx_gate_problem(N=11, T=4.0, free_phase=True,
                                                   device="cpu").build(device="cpu")[1],
                      b["Z0"], b["g0"], device="cpu",
                      options=pt.IPMOptions(max_iter=2, newton_dir=False))
    path = str(tmp_path / "port.npz")
    pck.save_solver_state(path, st)
    jlike, _ = jipm._setup(b["jnlp"], b["jq"].build()[1], b["jZ0"], b["jg0"],
                           jipm.IPMOptions())
    jst = jck.load_solver_state(path, like=jlike)
    for name in ("Z", "g", "lam", "gL", "gU", "mu", "it", "delta_w", "converged"):
        assert np.array_equal(np.asarray(getattr(jst, name)),
                              getattr(st, name).numpy()), name
    jpath = str(tmp_path / "jax.npz")
    jck.save_solver_state(jpath, jst)
    back = pck.load_solver_state(jpath, like=st)
    for name in ("Z", "g", "lam", "zL", "it", "stalled"):
        assert torch.equal(getattr(back, name), getattr(st, name)), name
    tree = {"b": [torch.arange(3.0), (torch.ones(2),)], "a": torch.zeros(1)}
    pck.save_pytree(str(tmp_path / "t.npz"), tree)
    assert sorted(np.load(str(tmp_path / "t.npz")).files) == \
        ["['a']", "['b']/[0]", "['b']/[1]/[0]"]
