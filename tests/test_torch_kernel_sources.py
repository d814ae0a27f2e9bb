"""Contracts between the CUDA sources (``csrc/*.cu``), which no compiler
checks here, and the Python that binds and launches them: entry points and
their arity, the mode constants, the product-pass tile shapes, no float
atomics, every source built; and the elasticity apply's launch plan at the
grid sizes users run.  Imports nothing of JAX."""

import re

import numpy as np
import pytest
import torch

from poroelasticity_dealii_torch.ops import _cuda
from poroelasticity_dealii_torch.ops import comp_major as cm

CSRC = _cuda._PKG / "csrc"
SOURCES = sorted(CSRC.glob("*.cu"))


def _entry_points():
    """{name: (parameter count, {dtype suffixes})} of every extern "C"
    function in the sources."""
    out = {}
    for src in SOURCES:
        text = src.read_text()
        block = text[text.index('extern "C" {'):]
        for name, suffix, params in re.findall(
                r"\bint\s+(\w+)_(f32|f64)\s*\(([^)]*)\)", block):
            count = len([p for p in params.split(",") if p.strip()])
            arity, suffixes = out.setdefault(name, (count, set()))
            assert arity == count, f"{name}: {arity} vs {count} parameters"
            suffixes.add(suffix)
    return out


def test_entry_points_match_signatures():
    found = _entry_points()
    assert set(found) == set(_cuda._SIGNATURES)
    for name, argtypes in _cuda._SIGNATURES.items():
        arity, suffixes = found[name]
        assert arity == len(argtypes), name
        assert suffixes == set(_cuda._SUFFIX.values()), name


def test_every_source_is_built():
    assert sorted(_cuda.SOURCES) == SOURCES


def test_no_float_atomics():
    for src in SOURCES:
        assert "atomicAdd" not in src.read_text(), src.name


def test_mode_constants_match():
    text = (CSRC / "comp_major.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (kUnmasked|kFree|kConstrained) = (\d+);", text)}
    assert consts == {"kUnmasked": cm.UNMASKED, "kFree": cm.FREE,
                      "kConstrained": cm.CONSTRAINED}


@pytest.mark.parametrize("dtype,ctype", [(torch.float32, "float"),
                                         (torch.float64, "double")])
def test_product_tile_matches_source(dtype, ctype):
    text = (CSRC / "comp_major.cu").read_text()
    body = re.search(r"struct ProductTile<%s> \{(.*?)\};" % ctype, text,
                     re.S).group(1)
    c = {k: int(v) for k, v in re.findall(
        r"static constexpr int (\w+) = (\d+);", body)}
    t = cm.PRODUCT_TILE[dtype]
    assert (c["kCells"], c["kMinBlocks"]) == (t["cells"], t["blocks_per_sm"])
    assert (c["kKRows"], c["kKCols"]) == t["k"]
    assert (c["kXRows"], c["kXStride"]) == t["x"]


SMEM_PER_BLOCK = 232_448        # H100: 227 KB opt-in per block
SMEM_PER_SM = 233_472           # 228 KB per SM, 1 KB of it kept per block
SMS = 132                       # H100 SXM


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 7, 21, 40, 56, 64])
def test_rows_apply_plan(n, dtype):
    plan = cm.rows_apply_plan(n, dtype, SMS)
    t = cm.PRODUCT_TILE[dtype]
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert t["blocks_per_sm"] * (plan.smem_bytes + 1024) <= SMEM_PER_SM
    # the K and X_E shapes cover the 81 x 81 product, float4/double2 rows
    assert min(t["k"]) >= 81 and t["x"][0] >= 81 and t["x"][1] >= t["cells"]
    assert plan.stride % plan.cells_per_tile == 0
    assert n ** 3 <= plan.stride < n ** 3 + plan.cells_per_tile
    assert plan.tiles * plan.cells_per_tile == plan.stride
    assert 1 <= plan.grid <= min(plan.tiles, SMS * t["blocks_per_sm"])
    # int32 indexing: the scratch, the row layout and its largest gather
    rows, W = cm._rows_shape(n)
    assert plan.scratch_numel < 2 ** 31 and rows * W < 2 ** 31
    assert int(cm._u_index(n, torch.device("cpu")).max()) < rows * W


@pytest.mark.parametrize("n", [2, 3])
def test_csr_yardstick_equals_free_apply(n):
    """tools/apply_bench's assembled CSR operator (the library yardstick)
    computes the FREE apply."""
    from poroelasticity_dealii_torch import read_input_file
    from poroelasticity_dealii_torch.solvers.structured import \
        build_grid_discretization
    from poroelasticity_dealii_torch.tools import apply_bench
    ro = build_grid_discretization(
        read_input_file("configs/consolidation_3d.data"), cells_per_axis=n,
        device="cpu").row_ops
    M = apply_bench.rows_free_csr(ro.ke, ro.free_mask_rows, n)
    x = ro.to_rows(torch.as_tensor(np.random.default_rng(n).standard_normal(
        3 * (2 * n + 1) ** 3))) * ro.free_mask_rows
    ref = cm.elasticity_rows_apply_plain(x, ro.free_mask_rows, ro.ke, n,
                                         cm.FREE)
    got = torch.mv(M, x.reshape(-1)).view_as(x)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-13
