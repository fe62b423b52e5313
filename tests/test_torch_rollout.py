"""The port's rollout against piccolax on the CPU in float64: the Pade-13
expm (K5's plain version) matrix by matrix, the ZOH rollout with and
without substeps, the rollout fidelity, the trajectory's own rollout, and
the batch axis over pulses."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.extend import core as jcore  # noqa: E402

import piccolax as px  # noqa: E402
from piccolax.quantum import dynamics as jdyn  # noqa: E402
import piccolax_torch as pt  # noqa: E402
from piccolax_torch import _kernels  # noqa: E402

jexpm = importlib.import_module("piccolax.ops.expm")
pexpm = importlib.import_module("piccolax_torch.ops.expm")

N, T = 21, 2.0


def _jax_squarings(A):
    """The squaring count inside piccolax.ops.expm.expm: its jaxpr cut at
    the int32 count and compiled, so XLA rounds it as it does in expm."""
    inner = jax.make_jaxpr(jexpm.expm)(A).jaxpr.eqns[0].params["jaxpr"]
    s = next(e.outvars[0] for e in inner.jaxpr.eqns
             if e.primitive.name == "convert_element_type"
             and e.params["new_dtype"] == jnp.int32)
    cut = jcore.ClosedJaxpr(inner.jaxpr.replace(outvars=[s]), inner.consts)
    return np.asarray(jax.jit(jcore.jaxpr_as_fun(cut))(A)[0])


@pytest.mark.parametrize("dtype,tol", [(np.complex128, 1e-13),
                                       (np.complex64, 1e-5)])
@pytest.mark.parametrize("n", [2, 3, 4, 9])
def test_expm_plain_matches_jax(n, dtype, tol):
    """Every squaring count 0..16 occurs and agrees matrix by matrix, also
    at norms within two ulps of 0.95 * 2^k. Each matrix agrees to tol
    relative for s <= 6 and to tol * 2^(s-6) above: s squarings multiply a
    rounding difference of the Pade result by up to 2^s (measured: 2e-16 *
    2^s in complex128)."""
    A = pexpm.anti_hermitian_by_squarings(139, n, np.random.default_rng(n), dtype)
    ref = np.asarray(jexpm.expm(jnp.asarray(A)))
    s_ref = _jax_squarings(jnp.asarray(A))
    At = torch.as_tensor(A)
    got = pt.expm(At).numpy()
    s = pexpm.pade13_squarings(At).numpy()
    assert got.dtype == dtype and got.shape == A.shape
    assert np.array_equal(s, s_ref)
    assert set(s.tolist()) == set(range(17))
    err = np.abs(got - ref).max(axis=(-2, -1)) / np.abs(ref).max(axis=(-2, -1))
    assert np.all(err <= tol * 2.0 ** np.maximum(s - 6, 0)), err.max()


@pytest.mark.parametrize("dtype,tol", [(np.complex128, 1e-12),
                                       (np.complex64, 1e-4)])
@pytest.mark.parametrize("n", [2, 3, 4, 9, 16])
def test_direct_pade13_solve_matches_jax(n, dtype, tol):
    """K5's kernel solves (V - U) F = V + U directly where piccolax runs 8
    Newton-Schulz steps: the same U and V (the port's _pade13_uv), F from
    torch.linalg.solve and the per-matrix s of pade13_squarings (held to
    piccolax's count by test_expm_plain_matches_jax) hold to piccolax's
    expm within chip_smoke.py's bar for the kernel, tol relative for
    s <= 6 and tol * 2^(s-6) above, on the inputs of
    test_expm_plain_matches_jax (every s 0..16)."""
    A = pexpm.anti_hermitian_by_squarings(139, n, np.random.default_rng(n), dtype)
    ref = np.asarray(jexpm.expm(jnp.asarray(A)))
    At = torch.as_tensor(A)
    s = pexpm.pade13_squarings(At)
    U, V = pexpm._pade13_uv(At * torch.pow(2.0, -s.double()).to(At.dtype)[..., None, None])
    F = torch.linalg.solve(V - U, V + U)
    for i in range(int(s.max())):
        F = torch.where((i < s)[..., None, None], F @ F, F)
    got, s = F.numpy(), s.numpy()
    assert got.dtype == dtype and set(s.tolist()) == set(range(17))
    err = np.abs(got - ref).max(axis=(-2, -1)) / np.abs(ref).max(axis=(-2, -1))
    assert np.all(err <= tol * 2.0 ** np.maximum(s - 6, 0)), err.max()


def _system():
    return (px.QuantumSystem(0.5 * px.PAULIS["Z"], [px.PAULIS["X"], px.PAULIS["Y"]], 1.0),
            pt.QuantumSystem(0.5 * pt.PAULIS["Z"], [pt.PAULIS["X"], pt.PAULIS["Y"]], 1.0))


def _random_pulse(seed=0, n_pulses=None):
    rng = np.random.default_rng(seed)
    shape = (N, 2) if n_pulses is None else (n_pulses, N, 2)
    return 0.8 * rng.standard_normal(shape)


@pytest.mark.parametrize("n_substeps", [1, 10])
def test_unitary_rollout_matches_jax(n_substeps):
    jsys, psys = _system()
    times = np.linspace(0, T, N)
    us = _random_pulse(1)
    ref = np.asarray(jdyn.unitary_rollout(jsys, px.ZeroOrderPulse(us, times),
                                          times, n_substeps=n_substeps))
    got = pt.unitary_rollout(psys, pt.ZeroOrderPulse(us, times), times,
                             n_substeps=n_substeps, device="cpu")
    assert got.shape == (N, 2, 2) and got.dtype == torch.complex128
    assert np.max(np.abs(got.numpy() - ref)) < 1e-12


def test_unitary_rollout_fidelity_matches_jax():
    jsys, psys = _system()
    rng = np.random.default_rng(2)
    times = np.concatenate([[0.0], np.cumsum(rng.uniform(0.05, 0.2, N - 1))])
    us = _random_pulse(3)
    goal = px.GATES["X"]
    ref = float(jdyn.unitary_rollout_fidelity(jsys, us, times, jnp.asarray(goal),
                                              interpolation="constant"))
    got = pt.unitary_rollout_fidelity(psys, us, times, goal,
                                      interpolation="constant", device="cpu")
    assert abs(got.item() - ref) < 1e-12
    with pytest.raises(NotImplementedError):
        pt.unitary_rollout_fidelity(psys, us, times, goal, device="cpu")


def test_batched_rollout_equals_single_rollouts():
    """A batch of pulses with their own knot times rolls out in one expm
    call and gives each pulse's own rollout; the scan keeps the later
    steps on the left (random non-commuting steps)."""
    _, psys = _system()
    rng = np.random.default_rng(4)
    B = 3
    times = np.concatenate([np.zeros((B, 1)),
                            np.cumsum(rng.uniform(0.05, 0.2, (B, N - 1)), 1)], 1)
    us = _random_pulse(5, B)
    goal = pt.GATES["X"]
    F = pt.unitary_rollout_fidelity(psys, us, times, goal,
                                    interpolation="constant", device="cpu")
    assert F.shape == (B,)
    for b in range(B):
        Us = pt.unitary_rollout(psys, pt.ZeroOrderPulse(us[b], times[b]), times[b],
                                n_substeps=10, device="cpu")
        assert abs(F[b].item() - pt.unitary_fidelity(Us[-1], goal).item()) < 1e-14
        # sequential left products, the definition of the rollout
        U = np.eye(2, dtype=complex)
        steps = pt.unitary_rollout(psys, pt.ZeroOrderPulse(us[b], times[b]),
                                   times[b], device="cpu").numpy()
        for k in range(N - 1):
            h = times[b, k + 1] - times[b, k]
            Hk = psys.H(torch.as_tensor(us[b, k])).numpy()
            U = pexpm.expm_plain(torch.as_tensor(-1j * h * Hk)).numpy() @ U
            assert np.max(np.abs(U - steps[k + 1])) < 1e-13


def test_unitary_trajectory_matches_jax():
    """Construction rollout, fidelity() and rollout() with a new pulse."""
    jsys, psys = _system()
    times = np.linspace(0, T, N)
    us, us2 = _random_pulse(6), _random_pulse(7)
    jq = px.UnitaryTrajectory(jsys, px.ZeroOrderPulse(us, times), px.GATES["X"])
    q = pt.UnitaryTrajectory(psys, pt.ZeroOrderPulse(us, times), pt.GATES["X"],
                             device="cpu")
    assert np.max(np.abs(q.Us.numpy() - np.asarray(jq.Us))) < 1e-12
    assert abs(float(q.fidelity()) - float(jq.fidelity())) < 1e-12
    jr = jq.rollout(px.ZeroOrderPulse(us2, times))
    r = q.rollout(pt.ZeroOrderPulse(us2, times))
    assert r.device == torch.device("cpu")
    assert abs(float(r.fidelity()) - float(jr.fidelity())) < 1e-12
    assert np.max(np.abs(q.state_iso(times[::2])
                         - np.asarray(jq.state_iso(times[::2])))) < 1e-12


def test_rollout_runs_no_kernel_and_never_falls_back():
    """On the CPU the wrappers take the plain version only because the
    tensors lie there: K5's counter stays 0, and an entry point given no
    device and no tensor raises without a card."""
    _, psys = _system()
    times = np.linspace(0, T, N)
    pulse = pt.ZeroOrderPulse(_random_pulse(8), times)
    _kernels.reset_launch_counts()
    pt.UnitaryTrajectory(psys, pulse, pt.GATES["X"], device="cpu")
    pt.expm(torch.zeros(4, 3, 3, dtype=torch.complex64))
    assert _kernels.LAUNCHES["expm_pade13"] == 0
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        pt.UnitaryTrajectory(psys, pulse, pt.GATES["X"])
    with pytest.raises(RuntimeError):
        pt.expm(np.eye(2, dtype=complex))
    with pytest.raises(RuntimeError):
        pt.unitary_rollout_fidelity(psys, pulse.values, times, pt.GATES["X"],
                                    interpolation="constant")


@pytest.mark.parametrize("bad", [
    torch.zeros(2, 2, dtype=torch.float64),            # not complex
    torch.zeros(17, 17, dtype=torch.complex128),       # n > 16
    torch.zeros(2, 3, dtype=torch.complex128),         # not square
])
def test_expm_rejects_inputs_off_the_kernel(bad):
    with pytest.raises((TypeError, ValueError)):
        pt.expm(bad)
