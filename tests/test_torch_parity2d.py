"""The 2D parity layout and the 2D flat stencils of the torch port against
the JAX package (``ops/parity2d.py``, ``ops/stencil.py`` with dim 2), in
float64 on the CPU from seeded numpy inputs: the layout maps and their
padding, the parity apply, coupling and projection, the rows-kit duck type,
and the flat Q2 stencils, each to 1e-12 relative to the JAX result's max.
Also the guard that the 2D path accumulates without float atomics."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from poroelasticity_dealii_tpu.ops import parity2d as jp  # noqa: E402
from poroelasticity_dealii_tpu.ops import stencil as js  # noqa: E402

from poroelasticity_dealii_torch import read_input_file  # noqa: E402
from poroelasticity_dealii_torch.ops import parity2d as tp  # noqa: E402
from poroelasticity_dealii_torch.ops import stencil as ts  # noqa: E402
from poroelasticity_dealii_torch.solvers import structured as tst  # noqa: E402
from poroelasticity_dealii_torch.solvers.fss import \
    FixedStressSolver  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
GOLDEN = "configs/golden_2d.data"
TOL = 1e-12
F64 = torch.float64


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _mats(n):
    """The golden deck's (Ke, Ce, Pe) at n cells per axis, float64."""
    d = tst.build_grid_discretization(read_input_file(GOLDEN),
                                      cells_per_axis=n, multigrid="off",
                                      elasticity_backend="conv", device="cpu")
    return d, d.element_ke, d.element_ce, d.element_pe


def _padding(n, nc=2):
    """1 at the class-1 padding entries of a parity tensor, else 0."""
    return 1.0 - tp.to_parity_np(np.ones((2 * n + 1) ** 2 * nc), n, nc)


@pytest.mark.parametrize("n", [4, 8])
def test_roundtrip_and_padding(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((2 * n + 1) ** 2 * 2)
    X = tp.to_parity(torch.tensor(x), n, 2)
    assert X.shape == (2, 2, 2, n + 1, n + 1)
    assert np.array_equal(X.numpy(), np.asarray(jp.to_parity(
        jnp.asarray(x), n, 2)))
    assert np.array_equal(X.numpy(), tp.to_parity_np(x, n, 2))
    assert torch.equal(tp.from_parity(X, n, 2), torch.tensor(x))
    pad = _padding(n)
    # the padding is the class-1 tail row/column, one of each class-1 axis
    assert pad.sum() == 2 * (2 * (n + 1) + 2 * (n + 1) - 1)
    assert not X.numpy()[pad > 0].any()
    d, Ke, Ce, Pe = _mats(n)
    kit = tp.make_parity_ops(Ke, n, d.free_mask_u.numpy(),
                             d.diag_elasticity.numpy(), Ce, Pe, F64, "cpu")
    # every operator keeps the padding exactly zero, and the masks hold it
    for y in (kit.apply_rows(X), kit.constrained_apply(X),
              kit.free_apply(X * kit.free_mask_rows),
              kit.coupling_rows(torch.tensor(rng.standard_normal(
                  (n + 1) ** 2)))):
        assert not y.numpy()[pad > 0].any()
    assert not kit.free_mask_rows.numpy()[pad > 0].any()
    assert (kit.diag_rows.numpy()[pad > 0] == 1.0).all()


@pytest.mark.parametrize("n", [4, 8])
def test_parity_operators_match_jax(n):
    rng = np.random.default_rng(10 + n)
    _, Ke, Ce, Pe = _mats(n)
    x = rng.standard_normal((2 * n + 1) ** 2 * 2)
    p = rng.standard_normal((n + 1) ** 2)
    X, XJ = tp.to_parity(torch.tensor(x), n, 2), jp.to_parity(
        jnp.asarray(x), n, 2)
    pairs = [
        (tp.make_apply_parity(Ke, n, 2, F64, "cpu")(X),
         jp.make_apply_parity(Ke, n, 2, jnp.float64)(XJ)),
        (tp.make_coupling_parity(Ce, n, 2, F64, "cpu")(torch.tensor(p)),
         jp.make_coupling_parity(Ce, n, 2, jnp.float64)(jnp.asarray(p))),
        (tp.make_projection_parity(Pe, n, 2, F64, "cpu")(X),
         jp.make_projection_parity(Pe, n, 2, jnp.float64)(XJ)),
    ]
    for got, want in pairs:
        assert got.shape == want.shape
        assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("n", [4, 8])
def test_parity_kit_matches_flat_operators(n):
    """The kit's constrained and free applies, coupling and projection
    equal the flat stencils through the layout maps, and the kit has the
    rows kit's names."""
    rng = np.random.default_rng(20 + n)
    d, Ke, Ce, Pe = _mats(n)
    kit = tp.make_parity_ops(Ke, n, d.free_mask_u.numpy(),
                             d.diag_elasticity.numpy(), Ce, Pe, F64, "cpu")
    x = torch.tensor(rng.standard_normal(d.n_udofs))
    p = torch.tensor(rng.standard_normal(d.n_pdofs))
    m = d.free_mask_u
    assert _rel(kit.from_rows(kit.constrained_apply(kit.to_rows(x))),
                d.elasticity_constrained(x)) <= TOL
    assert _rel(kit.from_rows(kit.free_apply(kit.to_rows(x * m))),
                m * d.elasticity(x * m)) <= TOL
    assert _rel(kit.from_rows(kit.coupling_rows(p)),
                d.coupling_rhs(p)) <= TOL
    assert _rel(kit.projection_rows(kit.to_rows(x)),
                d.strain_projection_rhs(x)) <= TOL
    assert torch.equal(kit.from_rows(kit.diag_rows), d.diag_elasticity)
    for name in ("free_mask_rows", "diag_rows", "to_rows", "from_rows",
                 "apply_rows", "constrained_apply", "free_apply",
                 "coupling_rows", "projection_rows", "local_rows"):
        assert hasattr(kit, name), name


CASES_2D = [(2, 2, 2, 2), (1, 2, 1, 2), (2, 1, 2, 3)]   # el, coupling, proj


@pytest.mark.parametrize("k_in,k_out,nc_in,nc_out", CASES_2D)
@pytest.mark.parametrize("n", [4, 8])
def test_flat_stencils_2d_match_jax(n, k_in, k_out, nc_in, nc_out):
    rng = np.random.default_rng(100 * n + 10 * k_in + k_out)
    M = rng.standard_normal(((k_out + 1) ** 2 * nc_out,
                             (k_in + 1) ** 2 * nc_in))
    x = rng.standard_normal((k_in * n + 1) ** 2 * nc_in)
    got = ts.make_stencil_apply(M, k_in, k_out, nc_in, nc_out, 2, n, F64,
                                "cpu")(torch.tensor(x))
    want = js.make_stencil_apply(M, k_in, k_out, nc_in, nc_out, 2, n,
                                 np.float64)(jnp.asarray(x))
    assert _rel(got.numpy(), want) <= TOL


# modules of the 2D path: their accumulations must be slice-adds
PATH_2D = ("ops/parity2d.py", "ops/stencil.py", "solvers/multigrid.py",
           "solvers/cg.py", "solvers/fss.py", "solvers/structured.py",
           "solvers/cuda_graphs.py", "solvers/discretization.py")
ATOMIC_CALLS = re.compile(
    r"index_add_?\(|scatter_add_?\(|scatter_reduce_?\(|index_reduce_?\(|"
    r"\.put_\(|accumulate\s*=\s*True")


def test_no_float_atomics_in_2d_sources():
    """No module on the 2D path calls a torch scatter that accumulates
    with atomics on the card (``index_add_``, ``scatter_add_``,
    ``index_put_(..., accumulate=True)``, ...): the right-hand sides must
    be bitwise repeatable for the skip-if-unchanged rule."""
    for rel in PATH_2D:
        code = (REPO / "poroelasticity_dealii_torch" / rel).read_text()
        assert not ATOMIC_CALLS.search(code), rel


class _Ops(torch.overrides.TorchFunctionMode):
    """Records the name of every torch function called under it."""

    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        if name == "index_put_" and kwargs.get("accumulate"):
            name = "index_put_(accumulate=True)"
        self.names.add(name)
        return func(*args, **kwargs)


@pytest.mark.parametrize("backend,multigrid", [("parity", "on"),
                                               ("conv", "on")])
def test_no_accumulating_scatter_runs_in_a_2d_step(backend, multigrid):
    """A whole 2D step (set-up excluded) at n = 8 calls no accumulating
    scatter."""
    data = read_input_file(GOLDEN)
    disc = tst.build_grid_discretization(data, cells_per_axis=8,
                                         multigrid=multigrid,
                                         elasticity_backend=backend,
                                         device="cpu")
    s = FixedStressSolver(disc, data)
    st = s.initial_state()
    with _Ops() as ops:
        s.time_step(st, data.time_step, 1.05, bc_scale_prev=1.0)
    bad = {n for n in ops.names if re.search(
        r"index_add|scatter_add|scatter_reduce|index_reduce|put_|"
        r"accumulate", n)}
    assert not bad, bad
    assert "matmul" in ops.names or "__matmul__" in ops.names
