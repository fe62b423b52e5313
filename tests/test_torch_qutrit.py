"""Config 2's building blocks in the port against piccolax, on the CPU:
`TransmonSystem` (every lab frame), the copied embedded-operator
functions and `EmbeddedOperator` with the subspace iso indices. The
solver-side parity of config 2 (the Pedersen fidelities, the embedded
rollout fidelity, the build, the costs and the first IPM iterates) is in
tests/test_torch_qutrit_build.py, kept apart: pytest-xdist's loadfile
schedule hands out files with more tests first, and a file of few tests
runs those costly ones after the suite's long JAX files."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from piccolax.quantum import isomorphisms as jiso  # noqa: E402
from piccolax.quantum import operators as jops  # noqa: E402
from piccolax.quantum.templates import TransmonSystem as JTransmon  # noqa: E402
import piccolax_torch as pt  # noqa: E402
from piccolax_torch.quantum import isomorphisms as piso  # noqa: E402
from piccolax_torch.quantum import operators as pops  # noqa: E402


@pytest.mark.parametrize("kw", [
    dict(), dict(levels=4, omega=5.0, delta=0.3, drive_bounds=0.2),
    dict(lab_frame=True), dict(lab_frame=True, lab_frame_type="quartic"),
    dict(lab_frame=True, lab_frame_type="cosine", levels=5),
    dict(frame_omega=3.5), dict(multiply_by_2pi=False, drives=False),
])
def test_transmon_system_matches_jax(kw):
    a, b = pt.TransmonSystem(**kw), JTransmon(**kw)
    assert a.levels == b.levels and a.n_drives == b.n_drives
    assert np.max(np.abs(a.get_drift() - np.asarray(b.get_drift()))) < 1e-12
    for x, y in zip(a.get_drives(), b.get_drives(), strict=True):
        assert np.max(np.abs(x - np.asarray(y))) < 1e-12
    assert np.array_equal(a.drive_bounds, np.asarray(b.drive_bounds))


_OPS = [
    ("embed", (np.array([[0, 1], [1, 0]]), [0, 1], 3)),
    ("embed", (np.arange(4).reshape(2, 2) * 1j, [1, 3], 4)),
    ("unembed", (np.arange(16).reshape(4, 4), [0, 2])),
    ("get_subspace_indices", ([0, 1], 3)),
    ("get_subspace_indices", ([[0, 1], [0, 1]], [3, 3])),
    ("get_subspace_indices", ([[0, 1], [1, 2]], [2, 4])),
    ("get_leakage_indices", ([0, 1], 3)),
    ("get_leakage_indices", ([0, 2, 3], 5)),
    ("get_iso_vec_subspace_indices", ([0, 1], 3)),
    ("get_iso_vec_subspace_indices", ([1, 3], 4)),
    ("get_iso_vec_leakage_indices", ([0, 1], 3)),
    ("get_iso_vec_leakage_indices", ([0, 4], 9)),
]


@pytest.mark.parametrize("name,args", _OPS)
def test_copied_embedding_functions_give_identical_outputs(name, args):
    a, b = getattr(pops, name)(*args), getattr(jops, name)(*args)
    assert type(a) is type(b) and np.array_equal(a, b)
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype


@pytest.mark.parametrize("args,kw", [
    ((np.array([[0, 1], [1, 0]]), [0, 1], [3]), {}),
    ((np.eye(4)[[0, 1, 3, 2]],), dict(subsystem_levels=[3, 3])),
    ((np.diag([1, 1j]),), dict(levels=4)),
])
def test_embedded_operator_matches_jax(args, kw):
    a, b = pops.EmbeddedOperator(*args, **kw), jops.EmbeddedOperator(*args, **kw)
    assert np.array_equal(a.operator, b.operator)
    assert a.subspace == b.subspace and a.subsystem_levels == b.subsystem_levels
    assert a.levels == b.levels
    assert np.array_equal(a.unembed(), b.unembed())
    for f in ("leakage_indices", "iso_vec_subspace_indices", "iso_vec_leakage_indices"):
        assert getattr(a, f)() == getattr(b, f)()
    assert np.array_equal((a @ a).operator, (b @ b).operator)
    for n in (3, 4, 9):
        sub = [s for s in a.subspace if s < n]
        assert np.array_equal(piso.operator_subspace_iso_indices(n, sub),
                              jiso.operator_subspace_iso_indices(n, sub))
