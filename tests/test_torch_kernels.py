"""The hand-written CUDA kernels against their plain twins, on the card.

Skipped without a CUDA device (the CPU suite); on a GPU machine run
``python -m pytest --noconftest tests/test_torch_kernels.py -m cuda``
(``tests/conftest.py`` sets up JAX, which a GPU machine need not have).
chip_smoke.py repeats these comparisons at the main path's 40^3 shapes."""

import numpy as np
import pytest
import torch

from poroelasticity_dealii_torch import read_input_file
from poroelasticity_dealii_torch.ops import comp_major as cm
from poroelasticity_dealii_torch.solvers.fss import FixedStressSolver
from poroelasticity_dealii_torch.solvers.structured import \
    build_grid_discretization

pytestmark = pytest.mark.cuda

DECK = "configs/consolidation_3d.data"
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [3, 7, 12])
def test_kernels_match_plain_twins(dev, n, dtype):
    d = build_grid_discretization(read_input_file(DECK), cells_per_axis=n,
                                  dtype=dtype, device=dev)
    ro = d.row_ops
    rng = np.random.default_rng(n)
    x = ro.to_rows(torch.as_tensor(rng.standard_normal(d.n_udofs),
                                   dtype=dtype, device=dev))
    xf = x * ro.free_mask_rows
    p = torch.as_tensor(rng.standard_normal(d.n_pdofs), dtype=dtype,
                        device=dev)
    cm.reset_launch_counts()
    pairs = [
        (ro.apply_rows(x),
         cm.elasticity_rows_apply_plain(x, None, ro.ke, n, cm.UNMASKED)),
        (ro.free_apply(xf), cm.elasticity_rows_apply_plain(
            xf, ro.free_mask_rows, ro.ke, n, cm.FREE)),
        (ro.constrained_apply(x), cm.elasticity_rows_apply_plain(
            x, ro.free_mask_rows, ro.ke, n, cm.CONSTRAINED)),
        (ro.coupling_rows(p), cm.coupling_rows_plain(p, ro.ce, n)),
        (ro.projection_rows(x), cm.projection_rows_plain(x, ro.pe, n)),
    ]
    torch.cuda.synchronize()
    calls = cm.launch_counts()
    assert [calls[fn.__name__] for fn in cm.KERNEL_WRAPPERS] == \
        [3, 1, 1, 0, 0, 0]
    for got, ref in pairs:
        assert got.shape == ref.shape
        assert _rel(got, ref) <= TOL[dtype]
    # bitwise repeatable, zero padding
    assert torch.equal(ro.coupling_rows(p), pairs[3][0])
    assert torch.equal(ro.free_apply(xf), pairs[1][0])
    assert not pairs[0][0][:, (n + 1) ** 2:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [5, 21])
def test_rhs_kernels_on_ragged_tiles(dev, n, dtype):
    """coupling_rows and projection_rows where the projection's last
    product tile is partial (n^3 % 256 and n^3 % 64 != 0): equal to the
    plain twins, bitwise repeatable; the projection kernel takes C = 6
    only and raises for another count."""
    d = build_grid_discretization(read_input_file(DECK), cells_per_axis=n,
                                  dtype=dtype, device=dev)
    ro = d.row_ops
    rng = np.random.default_rng(n)
    x = ro.to_rows(torch.as_tensor(rng.standard_normal(d.n_udofs),
                                   dtype=dtype, device=dev))
    p = torch.as_tensor(rng.standard_normal(d.n_pdofs), dtype=dtype,
                        device=dev)
    for fn, plain, inp, mat in (
            (cm.coupling_rows, cm.coupling_rows_plain, p, ro.ce),
            (cm.projection_rows, cm.projection_rows_plain, x, ro.pe)):
        got = fn(inp, mat, n)
        ref = plain(inp, mat, n)
        assert got.shape == ref.shape
        assert _rel(got, ref) <= TOL[dtype]
        assert torch.equal(fn(inp, mat, n), got)
    with pytest.raises(ValueError):
        cm.projection_rows(x, ro.pe[:40], n)


def test_step_on_card_matches_plain_twins(dev):
    data = read_input_file(DECK)
    runs = []
    for kernels in ("auto", "plain"):
        d = build_grid_discretization(data, cells_per_axis=4, device=dev,
                                      kernels=kernels)
        s = FixedStressSolver(d, data)
        runs.append(s.time_step(s.initial_state(), data.time_step, 1.05,
                                bc_scale_prev=1.0))
    (a, sa), (b, sb) = runs
    assert (sa.fss_iterations, sa.pressure_iterations) == \
        (sb.fss_iterations, sb.pressure_iterations)
    for k in ("p", "u", "strains"):
        assert _rel(getattr(a, k), getattr(b, k)) <= 1e-10
