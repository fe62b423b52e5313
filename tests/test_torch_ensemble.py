"""Config 4 (the robustness ensemble: SX problems whose drifts carry their
own detuning) in the port against piccolax, on the CPU in float64 at
n_samples = 3, N = 11, T = 4: the batched drift, residuals, cost and
derivative blocks of every sample under per-problem params, the params
carried across by `convert.nlp_from_numpy`, the first IPM iterates of one
sample, and `batch_solve` against solves of one problem at a time.

piccolax's jitted functions take the sample's params as an argument, so
each compiles once for the three samples."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from piccolax import benchmarks as jbm  # noqa: E402
from piccolax.solver import ipm as jipm  # noqa: E402
from piccolax.solver.nlp import nlp_constraint_residuals as jres  # noqa: E402
from piccolax.solver.nlp import nlp_total_cost as jcost  # noqa: E402
import piccolax_torch as pt  # noqa: E402
from piccolax_torch.convert import nlp_from_numpy  # noqa: E402
from piccolax_torch.quantum.systems import RealGeneratorSystem  # noqa: E402
from piccolax_torch.solver import ipm as pipm  # noqa: E402

S, N, T, M, DZ = 3, 11, 4.0, 12, 14
OPTS = dict(max_iter=30, tol=1e-6, constr_viol_tol=1e-6, newton_dir=False)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _sample(tree, b):
    return jax.tree_util.tree_map(lambda x: x[b], tree)


@pytest.fixture(scope="module")
def ens():
    jnlp, jparams, jZ0, jlay = jbm.robustness_ensemble(n_samples=S, N=N, T=T)
    nlp, params, Z0, lay = pt.robustness_ensemble(n_samples=S, N=N, T=T,
                                                  device="cpu")
    return dict(jnlp=jnlp, jparams=jparams, jZ0=np.asarray(jZ0), jlay=jlay,
                nlp=nlp, params=params, Z0=Z0, lay=lay)


def test_batched_drift_matches_jax(ens):
    """The per-sample drift generators equal piccolax's to 1e-14, the
    drives are piccolax's (shared), and the other leaves carry the batch."""
    e = ens
    jsys = e["jparams"]["system"]
    sysv = e["params"]["system"]
    assert sysv.G_drift.shape == (S, 4, 4)
    assert np.max(np.abs(sysv.G_drift.numpy() - np.asarray(jsys.drift_terms[0].H))) < 1e-14
    for i, d in enumerate(jsys.drive_terms):
        ref = np.asarray(d.H)
        assert np.array_equal(ref, np.broadcast_to(ref[0], ref.shape))
        assert np.max(np.abs(sysv.G_drives[i].numpy() - ref[0])) < 1e-14
    assert np.max(np.abs(e["params"]["goal"]["U"].numpy()
                         - np.asarray(e["jparams"]["goal"]["U"]))) < 1e-14
    for n, v in e["params"]["frozen"].items():
        assert np.array_equal(v.numpy(), np.asarray(e["jparams"]["frozen"][n]))
    assert np.array_equal(e["params"]["pin_val"].numpy(),
                          np.asarray(e["jparams"]["pin_val"]))
    assert e["lay"].slices == e["jlay"].slices
    assert e["Z0"].shape == (S, N, DZ)
    assert np.max(np.abs(e["Z0"].numpy() - e["jZ0"])) < 1e-12


def test_derivatives_of_every_sample_match_jax(ens):
    """Residuals, cost, Cself, Cnext, the cost gradient and the Lagrangian
    Hessians of the three samples, batched in the port under per-problem
    params and one sample at a time in piccolax: 1e-10 relative."""
    e = ens
    rng = np.random.default_rng(5)
    Z = e["jZ0"] + 0.05 * rng.standard_normal((S, N, DZ))
    lam = rng.standard_normal((S, N, M))
    g0 = jnp.zeros(0)
    jf = jax.jit(lambda p, Zj, lj: (
        jres(e["jnlp"], Zj, g0, p), jcost(e["jnlp"], Zj, g0, p),
        jipm._jacobians(e["jnlp"], Zj, g0, p)[:2],
        jipm._gradients(e["jnlp"], Zj, g0, p)[0],
        jipm._stage_hessians_split(e["jnlp"], Zj, g0, p, lj)))
    Zt = torch.as_tensor(Z)
    c = pt.solver.nlp_constraint_residuals(e["nlp"], Zt, None, e["params"])
    f = pt.solver.nlp_total_cost(e["nlp"], Zt, None, e["params"])
    g, Cs, Cn, H = pipm._derivatives(e["nlp"], Zt, e["params"], torch.as_tensor(lam))
    for b in range(S):
        c_r, f_r, (Cs_r, Cn_r), g_r, H_r = jax.tree_util.tree_map(
            np.asarray, jf(_sample(e["jparams"], b), jnp.asarray(Z[b]),
                           jnp.asarray(lam[b])))
        assert _rel(c[b].numpy(), c_r) < 1e-10, b
        assert abs(f[b].item() - float(f_r)) < 1e-10 * max(1.0, abs(float(f_r))), b
        assert _rel(Cs[b].numpy(), Cs_r) < 1e-10, b
        assert _rel(Cn[b].numpy(), Cn_r) < 1e-10, b
        assert _rel(g[b].numpy(), g_r) < 1e-10, b
        assert _rel(H[b].numpy(), H_r) < 1e-10, b
    # the samples differ: the detuning reaches the residuals
    assert _rel(c[0].numpy(), c[1].numpy()) > 1e-6


def _jax_batch_arrays(e):
    """piccolax's params_batch as the numpy arrays of convert.nlp_from_numpy."""
    jp, jnlp = e["jparams"], e["jnlp"]
    sysv = jp["system"]
    return {
        "Z0": e["jZ0"], "lo": np.asarray(jnlp.lo), "hi": np.asarray(jnlp.hi),
        "pin_mask": np.asarray(jnlp.pin_mask),
        "pin_val": np.asarray(jp["pin_val"]),
        "dt": np.asarray(jp["frozen"]["dt"])[..., 0],
        "t": np.asarray(jp["frozen"]["t"])[..., 0],
        "G_drift": np.asarray(sysv.drift_terms[0].H),
        "G_drives": np.stack([np.asarray(d.H)[0] for d in sysv.drive_terms]),
        "goal": np.asarray(jp["goal"]["U"]), "Q": 100.0,
        "R": [1e-2, 1e-2, 1e-2],
        "slices": {n: (s.start, s.stop) for n, s in e["jlay"].slices.items()},
        "state_name": "U", "drive_name": "u", "squarings": 0,
    }


def test_nlp_from_numpy_carries_params_batch(ens):
    """piccolax's params_batch, carried across as numpy arrays, gives the
    port's batched params: residuals, cost and derivatives equal to 1e-12
    to those of the port's own ensemble."""
    e = ens
    nlp2, params2, Z02, _, _ = nlp_from_numpy(_jax_batch_arrays(e), device="cpu")
    assert params2["system"].G_drift.shape == (S, 4, 4)
    assert torch.allclose(Z02, e["Z0"], rtol=0, atol=1e-12)
    rng = np.random.default_rng(6)
    Z = e["Z0"] + 0.05 * torch.as_tensor(rng.standard_normal((S, N, DZ)))
    lam = torch.as_tensor(rng.standard_normal((S, N, M)))
    for fn in (lambda n, p: pt.solver.nlp_constraint_residuals(n, Z, None, p),
               lambda n, p: pt.solver.nlp_total_cost(n, Z, None, p),
               lambda n, p: pipm._derivatives(n, Z, p, lam)[3]):
        assert torch.allclose(fn(e["nlp"], e["params"]), fn(nlp2, params2),
                              rtol=0, atol=1e-12)


def test_first_iterates_of_a_sample_match_jax(ens):
    """Three IPM iterations of the batch under per-problem params against
    piccolax's IPM body on sample 2 alone (its own drift): Z, lam and mu
    to 1e-8 relative."""
    e = ens
    b = 2
    jopts = jipm.IPMOptions(**OPTS)
    s, jbody = jipm._setup(e["jnlp"], _sample(e["jparams"], b),
                           jnp.asarray(e["jZ0"][b]), None, jopts)
    jbody = jax.jit(jbody)
    state, body = pipm._setup(e["nlp"], e["params"], e["Z0"], None,
                              pipm.IPMOptions(**OPTS))
    for it in range(3):
        s = jbody(s)
        state = body(state)
        for name in ("Z", "lam", "mu"):
            assert _rel(getattr(state, name)[b].numpy(),
                        getattr(s, name)) < 1e-8, (it, name)


def _sample_params(params, b):
    """Problem b of the port's batched params, as an unbatched problem."""
    sysv = params["system"]
    return {"system": RealGeneratorSystem(sysv.G_drift[b], sysv.G_drives,
                                          sysv.levels),
            "goal": {n: v[b] for n, v in params["goal"].items()},
            "frozen": {n: v[b] for n, v in params["frozen"].items()},
            "pin_val": params["pin_val"][b]}


def test_batch_solve_equals_each_sample_alone(ens):
    """batch_solve of the three samples against three solves of one
    problem each: the same iterations and converged flags, Z to 1e-10.
    At tol 1e-4 two samples converge at iteration 19 and the third needs
    20, so max_iter=19 holds both a converged problem and one stopped at
    max_iter in the batch."""
    e = ens
    opts = pt.IPMOptions(**{**OPTS, "max_iter": 19, "tol": 1e-4,
                            "constr_viol_tol": 1e-4})
    st = pt.batch_solve(e["nlp"], e["params"], e["Z0"], options=opts, device="cpu")
    for b in range(S):
        one = pt.solve_nlp(e["nlp"], _sample_params(e["params"], b), e["Z0"][b],
                           options=opts, device="cpu")
        assert int(st.it[b]) == int(one.it)
        assert bool(st.converged[b]) == bool(one.converged)
        assert np.max(np.abs(st.Z[b].numpy() - one.Z.numpy())) < 1e-10, b
    assert sorted(st.converged.tolist()) == [False, True, True]


def test_batch_solve_checks_the_batch_and_the_mesh(ens):
    e = ens
    opts = pt.IPMOptions(max_iter=1, newton_dir=False)
    with pytest.raises(NotImplementedError):
        pt.batch_solve(e["nlp"], e["params"], e["Z0"], options=opts, mesh=object(),
                       device="cpu")
    with pytest.raises(ValueError):
        pt.batch_solve(e["nlp"], e["params"], e["Z0"][:2], options=opts, device="cpu")
