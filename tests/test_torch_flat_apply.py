"""The flat Q2 elasticity apply, the port's counterpart of the JAX
package's K6 (``make_pallas_apply``, ``pallas_comp_major.py:1363/1413``) and
K7 (``make_pallas_elasticity``, ``pallas_elasticity.py:108/154``).

On the CPU both port entry points take the kernel's plain twin; they are
held against the JAX Pallas kernels in interpret mode, on the same u made
by numpy from a seed: relative to max |y|, 1e-5 in float32 (the two sum in
different orders) and 1e-11 in float64.  The CUDA kernel itself is held
against its twin by the ``cuda``-marked test, which skips without a card.
JAX is imported only by the tests that compare with it, so the file also
runs on a GPU machine without JAX
(``python -m pytest --noconftest tests/test_torch_flat_apply.py -m cuda``).
"""

import numpy as np
import pytest
import torch

from poroelasticity_dealii_torch import read_input_file
from poroelasticity_dealii_torch.ops import comp_major as cm
from poroelasticity_dealii_torch.ops import elasticity as eg
from poroelasticity_dealii_torch.tools import apply_bench

DECK = "configs/consolidation_3d.data"
TOL = {"float32": 1e-5, "float64": 1e-11}
TORCH = {"float32": torch.float32, "float64": torch.float64}


@pytest.fixture(scope="module")
def jx():
    """The JAX modules the comparisons need (skip where JAX is absent)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from poroelasticity_dealii_tpu.ops import pallas_comp_major as jcm
    from poroelasticity_dealii_tpu.ops import pallas_elasticity as jel
    return jnp, jcm, jel


def _u(n, seed=1):
    return np.random.default_rng(seed).standard_normal((2 * n + 1) ** 3 * 3)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n,tc", [(4, 2), (6, 4)])
def test_k6_entry_point_matches_pallas_interpret(jx, n, tc, dtype):
    jnp, jcm, jel = jx
    ke = jel.elasticity_element_matrix(read_input_file(DECK), n)
    u = _u(n)
    want = jcm.make_pallas_apply(ke, n, getattr(jnp, dtype), tc=tc,
                                 interpret=True)(jnp.asarray(u, dtype))
    got = cm.make_flat_apply(ke, n, TORCH[dtype], "cpu")(
        torch.as_tensor(u, dtype=TORCH[dtype]))
    assert got.dtype == TORCH[dtype] and got.shape == (u.size,)
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n,tz", [(4, 2), (6, 3)])
def test_k7_entry_point_matches_pallas_interpret(jx, n, tz, dtype):
    jnp, jcm, jel = jx
    ke = jel.elasticity_element_matrix(read_input_file(DECK), n)
    u = _u(n)
    want = jel.make_pallas_elasticity(ke, n, dtype=getattr(jnp, dtype),
                                      tz=tz, interpret=True)(
        jnp.asarray(u, dtype))
    got = eg.make_grid_elasticity(ke, n, TORCH[dtype], "cpu")(
        torch.as_tensor(u, dtype=TORCH[dtype]))
    assert got.dtype == TORCH[dtype] and got.shape == (u.size,)
    assert _rel(got, want) <= TOL[dtype]


def test_element_matrix_equals_jax(jx):
    _, _, jel = jx
    data = read_input_file(DECK)
    for n in (3, 8):
        np.testing.assert_array_equal(eg.elasticity_element_matrix(data, n),
                                      jel.elasticity_element_matrix(data, n))


@pytest.mark.parametrize("n", [1, 3, 4])
def test_split_merge_parities_equal_jax(jx, n):
    jnp, _, jel = jx
    g = 2 * n + 1
    U = np.random.default_rng(n).standard_normal((g, g, g, 3))
    parts = eg.split_parities(torch.as_tensor(U), n)
    np.testing.assert_array_equal(parts.numpy(),
                                  np.asarray(jel.split_parities(
                                      jnp.asarray(U), n)))
    np.testing.assert_array_equal(eg.merge_parities(parts, n).numpy(), U)
    np.testing.assert_array_equal(
        eg.merge_parities(parts, n).numpy(),
        np.asarray(jel.merge_parities(jnp.asarray(parts.numpy()), n)))


def test_plain_twin_is_the_conv_stencil_and_repeats():
    """The twin equals the conv backend's plain stencil bitwise (same
    gather, same product, same scatter) and repeats bitwise; on the CPU no
    launch is counted.  The FLOP count takes 2 per nonzero of the element
    matrix per cell (5619 of 6561 on the deck's cell)."""
    rec = apply_bench.run(3, torch.float64, "cpu")
    assert rec["launches"] == {"make_flat_apply": 0,
                               "make_grid_elasticity": 0}
    assert rec["rel_err_vs_conv"] == {"make_flat_apply": 0.0,
                                      "make_grid_elasticity": 0.0}
    assert rec["bitwise_repeat"] and rec["rel_err_vs_plain"] == 0.0
    ke = eg.elasticity_element_matrix(read_input_file(DECK), 3)
    assert apply_bench.nonzeros(ke) == 5619
    assert rec["flop"] == 2 * 5619 * 27 and "ms" not in rec
    assert eg.elasticity_grid_apply in cm.KERNEL_WRAPPERS


def test_wrapper_checks_its_inputs():
    ke = torch.zeros((81, 81), dtype=torch.float64)
    with pytest.raises(ValueError):
        eg.elasticity_grid_apply(torch.zeros(10, dtype=torch.float64,
                                             device="meta"), ke, 1)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 4, 7, 21])
def test_cuda_kernel_matches_plain_twin(cuda_dev, n, dtype):
    """n = 1, 4, 7: one partial product tile; 21: ragged last tiles and
    tiles that span several x-rows of cells."""
    dev = cuda_dev
    ke_np = eg.elasticity_element_matrix(read_input_file(DECK), n)
    ke = torch.as_tensor(ke_np, dtype=dtype, device=dev)
    u = torch.as_tensor(_u(n), dtype=dtype, device=dev)
    cm.reset_launch_counts()
    y6 = cm.make_flat_apply(ke_np, n, dtype, dev)(u)
    y7 = eg.make_grid_elasticity(ke_np, n, dtype, dev)(u)
    ref = eg.elasticity_grid_apply_plain(u, ke, n)
    torch.cuda.synchronize()
    assert cm.launch_counts()["elasticity_grid_apply"] == 2
    tol = {torch.float32: 1e-5, torch.float64: 1e-12}[dtype]
    for y in (y6, y7):
        assert y.shape == u.shape
        assert ((y - ref).abs().max() / ref.abs().max()).item() <= tol
    assert torch.equal(y6, y7)                       # bitwise repeatable


@pytest.mark.cuda
def test_conv_step_on_card_runs_the_flat_kernel(cuda_dev):
    """A conv-backend step on the card applies its elasticity through the
    flat kernel (at least once per mechanics CG iteration); with
    ``kernels="plain"`` it launches nothing and gives the same FSS and
    pressure counts and nearly the same fields."""
    from poroelasticity_dealii_torch.solvers.fss import FixedStressSolver
    from poroelasticity_dealii_torch.solvers.structured import \
        build_grid_discretization
    data = read_input_file(DECK)
    runs = {}
    for kernels in ("auto", "plain"):
        d = build_grid_discretization(data, cells_per_axis=4,
                                      elasticity_backend="conv",
                                      device=cuda_dev, kernels=kernels)
        s = FixedStressSolver(d, data)
        st = s.initial_state()
        cm.reset_launch_counts()
        st, stats = s.time_step(st, data.time_step, 1.05, bc_scale_prev=1.0)
        torch.cuda.synchronize()
        runs[kernels] = (st, stats,
                         cm.launch_counts()["elasticity_grid_apply"])
    (a, sa, la), (b, sb, lb) = runs["auto"], runs["plain"]
    assert sa.mech_cg_iterations > 0
    assert la >= sa.mech_cg_iterations and lb == 0
    assert (sa.fss_iterations, sa.pressure_iterations) == \
        (sb.fss_iterations, sb.pressure_iterations)
    for k in ("p", "u"):
        ref = getattr(b, k)
        assert ((getattr(a, k) - ref).abs().max()
                / ref.abs().max()).item() <= 1e-10
