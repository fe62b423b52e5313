"""The port's data layer, problem conversion and boundaries: the same
problem data as piccolax, no JAX in the port, no silent CPU fallback, and
NotImplementedError for every option off the ported slice."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from piccolax import benchmarks as jbm  # noqa: E402
from piccolax import verification as jver  # noqa: E402
from piccolax.solver.nlp import nlp_total_cost as jcost  # noqa: E402
import piccolax_torch as pt  # noqa: E402
from piccolax_torch import verification as pver  # noqa: E402
from piccolax_torch.control.objectives import QuadraticRegularizer  # noqa: E402
from piccolax_torch.convert import nlp_from_numpy  # noqa: E402
from piccolax_torch.solver import ipm as pipm  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
N, T = 11, 4.0


def _jax_arrays(jprob):
    """The arrays of a piccolax build, in the format of piccolax_torch.convert."""
    nlp, params, Z0, _, layout = jprob.build()
    sysv = params["system"]
    bil = jprob.integrators[0]
    regs = {o.name: o.R for o in jprob.objectives if hasattr(o, "R")}
    u = bil.drive_name
    return {
        "Z0": np.asarray(Z0), "lo": np.asarray(nlp.lo), "hi": np.asarray(nlp.hi),
        "pin_mask": np.asarray(nlp.pin_mask),
        "pin_val": np.asarray(params["pin_val"]),
        "dt": np.asarray(params["frozen"]["dt"])[:, 0],
        "t": np.asarray(params["frozen"]["t"])[:, 0],
        "G_drift": np.asarray(sysv.drift_terms[0].H),
        "G_drives": np.stack([np.asarray(d.H) for d in sysv.drive_terms]),
        "goal": np.asarray(params["goal"][bil.state_name]),
        "Q": jprob.objectives[0].Q,
        "R": [regs.get(n, 0.0) for n in (u, "d" + u, "dd" + u)],
        "slices": {n: (s.start, s.stop) for n, s in layout.slices.items()},
        "state_name": bil.state_name, "drive_name": u,
        "squarings": bil.squarings,
    }


def problem_arrays(prob):
    """The arrays of a piccolax_torch problem built on the host, in the
    format of piccolax_torch.convert."""
    nlp, params, Z0, _, layout = prob.build(device="cpu")
    bil = nlp.integrators[0]
    regs = {o.name: o.R for o in nlp.objectives
            if isinstance(o, QuadraticRegularizer)}
    u = bil.drive_name
    return {
        "Z0": Z0.numpy(), "lo": nlp.lo.numpy(), "hi": nlp.hi.numpy(),
        "pin_mask": nlp.pin_mask.numpy(), "pin_val": params["pin_val"].numpy(),
        "dt": params["frozen"]["dt"][:, 0].numpy(),
        "t": params["frozen"]["t"][:, 0].numpy(),
        "G_drift": params["system"].G_drift.numpy(),
        "G_drives": params["system"].G_drives.numpy(),
        "goal": params["goal"][bil.state_name].numpy(),
        "Q": nlp.objectives[0].Q,
        "R": [regs.get(n, 0.0) for n in (u, "d" + u, "dd" + u)],
        "slices": {n: (s.start, s.stop) for n, s in layout.slices.items()},
        "state_name": bil.state_name, "drive_name": u,
        "squarings": bil.squarings,
    }


@pytest.fixture(scope="module")
def arrays():
    return (_jax_arrays(jbm.sx_gate_problem(N=N, T=T)),
            problem_arrays(pt.sx_gate_problem(N=N, T=T, device="cpu")))


@pytest.mark.parametrize("key", ["Z0", "lo", "hi", "pin_mask", "pin_val", "dt",
                                 "t", "G_drift", "G_drives", "goal"])
def test_data_layer_arrays_match_jax(arrays, key):
    ref, got = arrays
    a, b = np.asarray(got[key]), np.asarray(ref[key])
    assert a.shape == b.shape
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    fin = np.isfinite(b)
    assert np.all(a[~fin] == b[~fin])
    assert np.max(np.abs(a[fin] - b[fin]), initial=0.0) < 1e-12


@pytest.mark.parametrize("key", ["Q", "R", "slices", "state_name",
                                 "drive_name", "squarings"])
def test_data_layer_structure_matches_jax(arrays, key):
    ref, got = arrays
    assert got[key] == ref[key]


def test_sx_config1_shapes_and_squarings():
    """Config 1: N = 50, dz = 14 (U 8, u 2, du 2, ddu 2), m = 12; the
    feasible-box bound dt * ||H|| = 10/49 keeps the Taylor squarings at 0."""
    a = problem_arrays(pt.sx_gate_problem(device="cpu"))
    assert a["Z0"].shape == (50, 14)
    assert a["slices"] == {"U": (0, 8), "u": (8, 10), "du": (10, 12),
                           "ddu": (12, 14)}
    assert a["squarings"] == 0
    assert a["pin_mask"].sum() == 8 + 2 + 2


def test_nlp_from_numpy_matches_own_build(arrays):
    """Arrays taken from piccolax give the NLP the port builds itself."""
    ref, _ = arrays
    nlp, params, Z0, _, _ = pt.sx_gate_problem(N=N, T=T, device="cpu").build(
        device="cpu")
    nlp2, params2, Z02, _, _ = nlp_from_numpy(ref, device="cpu")
    assert torch.equal(Z0, Z02)
    rng = np.random.default_rng(2)
    Z = Z0 + 0.05 * torch.as_tensor(rng.standard_normal((3, N, 14)))
    lam = torch.as_tensor(rng.standard_normal((3, N, 12)))
    for f in (lambda n, p: pt.solver.nlp_constraint_residuals(n, Z, None, p),
              lambda n, p: pt.solver.nlp_total_cost(n, Z, None, p),
              lambda n, p: pipm._derivatives(n, Z, p, lam)[3]):
        assert torch.allclose(f(nlp, params), f(nlp2, params2), rtol=0,
                              atol=1e-12)


def test_verification_copy_gives_identical_outputs():
    rng = np.random.default_rng(4)
    us = 0.3 * rng.standard_normal((3, 6, 2))
    times = np.linspace(0, 2.0, 6)
    X = np.array([[0, 1], [1, 0]], complex)
    Y = np.array([[0, -1j], [1j, 0]], complex)
    a = jver.batched_unitary_dop853(np.zeros((2, 2)), [X / 2, Y / 2], us, times)
    b = pver.batched_unitary_dop853(np.zeros((2, 2)), [X / 2, Y / 2], us, times)
    assert np.array_equal(a, b)
    goal = pt.GATES["SX"]
    assert np.array_equal(jver.unitary_fidelity_np(a, goal),
                          pver.unitary_fidelity_np(b, goal))
    x = rng.standard_normal((3, 8))
    assert np.array_equal(jver.iso_vec_to_operator_np(x),
                          pver.iso_vec_to_operator_np(x))


# -- isolation ---------------------------------------------------------------


def test_port_imports_no_jax_at_runtime():
    code = ("import sys, piccolax_torch, piccolax_torch.verification; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'piccolax')]; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_import_no_jax():
    files = sorted((REPO / "piccolax_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "piccolax"}
        assert not bad, f"{f}: imports {bad}"


# -- no silent CPU fallback ----------------------------------------------------


def test_entry_points_without_device_raise_without_a_card(arrays):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        pt.sx_gate_problem(N=N, T=T)
    prob = pt.sx_gate_problem(N=N, T=T, device="cpu")
    with pytest.raises(RuntimeError):
        prob.build()
    with pytest.raises(RuntimeError):
        nlp_from_numpy(arrays[0])
    nlp, params, Z0, _, _ = prob.build(device="cpu")
    with pytest.raises(RuntimeError):
        pt.solve_nlp(nlp, params, Z0[None])


# -- options off the slice ---------------------------------------------------


@pytest.mark.parametrize("opts", [dict(kkt_backend="native")])
def test_unported_solver_options_raise(opts):
    nlp, params, Z0, _, _ = pt.sx_gate_problem(N=N, T=T, device="cpu").build(
        device="cpu")
    o = {"newton_dir": False, **opts}
    with pytest.raises(NotImplementedError):
        pt.solve_nlp(nlp, params, Z0[None], options=pt.IPMOptions(**o),
                     device="cpu")


@pytest.mark.parametrize("kw", [dict(options=object())])
def test_unported_template_options_raise(kw):
    with pytest.raises(NotImplementedError):
        pt.sx_gate_problem(N=N, T=T, device="cpu", **kw)


def test_leakage_options_build_the_cost_of_jax():
    """sx_gate_problem(leakage_indices=[1], leakage_cost=1.0): a leakage
    cost on iso-vec entry 1 of every knot, the cost piccolax builds (1e-12
    at a perturbed Z0); leakage_cost alone on a goal without a subspace
    derives no indices and adds no term, as in piccolax."""
    kw = dict(leakage_indices=[1], leakage_cost=1.0)
    jnlp, jparams, jZ0, jg0, _ = jbm.sx_gate_problem(N=N, T=T, **kw).build()
    prob = pt.sx_gate_problem(N=N, T=T, device="cpu", **kw)
    nlp, params, Z0, _, _ = prob.build(device="cpu")
    assert type(prob.objectives[-1]).__name__ == "LeakageObjective"
    Z = np.asarray(jZ0) + 0.05 * np.random.default_rng(3).standard_normal(Z0.shape)
    f_ref = float(jcost(jnlp, Z, jg0, jparams))
    f = pt.solver.nlp_total_cost(nlp, torch.as_tensor(Z), None, params).item()
    assert abs(f - f_ref) < 1e-12 * max(1.0, abs(f_ref))
    nlp0 = pt.sx_gate_problem(N=N, T=T, device="cpu").build(device="cpu")[0]
    assert f > pt.solver.nlp_total_cost(nlp0, torch.as_tensor(Z), None, params).item()
    alone = pt.sx_gate_problem(N=N, T=T, device="cpu", leakage_cost=1.0)
    assert [type(o).__name__ for o in alone.objectives] == \
        [type(o).__name__ for o in jbm.sx_gate_problem(N=N, T=T, leakage_cost=1.0).objectives]
