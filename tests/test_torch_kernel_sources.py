"""Contracts between the CUDA sources (``csrc/*.cu``), which no compiler
checks here, and the Python that binds and launches them: entry points and
their arity, the mode constants, the product-pass tile shapes of the
elasticity apply and the projection, one product-pass body for both input
layouts and the flat layout's offsets against the conv stencil's gather, no
float atomics, every source built; the product pass's launch plans and the
coupling kernel's launch geometry at the grid sizes users run; and the
library yardsticks' assembled operators against the plain twins.  Imports
nothing of JAX."""

import re

import numpy as np
import pytest
import torch

from poroelasticity_dealii_torch.ops import _cuda
from poroelasticity_dealii_torch.ops import cell_products as cp
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
    """No atomic of any kind (CUDA atomic* calls, PTX red.*) in the code of
    any source: each output value is summed by one thread in a fixed order,
    so the results repeat bitwise."""
    for src in SOURCES:
        code = re.sub(r"//[^\n]*|/\*.*?\*/", "", src.read_text(), flags=re.S)
        assert not re.search(r"\batomic\w*|\bred\.", code), src.name


def test_mode_constants_match():
    text = (CSRC / "comp_major.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (kUnmasked|kFree|kConstrained) = (\d+);", text)}
    assert consts == {"kUnmasked": cm.UNMASKED, "kFree": cm.FREE,
                      "kConstrained": cm.CONSTRAINED}


def _tile_constants(ctype: str, rows: str) -> dict:
    """The constants of ``ProductTile<ctype, rows>`` in the source."""
    text = (CSRC / "comp_major.cu").read_text()
    body = re.search(r"struct ProductTile<%s, %s> \{(.*?)\};"
                     % (ctype, rows), text, re.S).group(1)
    return {k: int(v) for k, v in re.findall(
        r"static constexpr int (\w+) = (\d+);", body)}


def _source_int(name: str) -> int:
    text = (CSRC / "comp_major.cu").read_text()
    return int(re.search(r"constexpr int %s = (\d+);" % name, text).group(1))


@pytest.mark.parametrize("dtype,ctype", [(torch.float32, "float"),
                                         (torch.float64, "double")])
def test_product_tile_matches_source(dtype, ctype):
    c = _tile_constants(ctype, "kLocal")
    t = cp.PRODUCT_TILE[dtype]
    assert (c["kCells"], c["kMinBlocks"]) == (t["cells"], t["blocks_per_sm"])
    assert (c["kKRows"], c["kKCols"]) == t["k"]
    assert (c["kXRows"], c["kXStride"]) == t["x"]


SMEM_PER_BLOCK = 232_448        # H100: 227 KB opt-in per block
SMEM_PER_SM = 233_472           # 228 KB per SM, 1 KB of it kept per block
SMS = 132                       # H100 SXM


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 7, 21, 40, 56, 64])
def test_rows_apply_plan(n, dtype):
    plan = cp.rows_apply_plan(n, dtype, SMS)
    t = cp.PRODUCT_TILE[dtype]
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert t["blocks_per_sm"] * (plan.smem_bytes + 1024) <= SMEM_PER_SM
    # the K and X_E shapes cover the 81 x 81 product, float4/double2 rows
    assert min(t["k"]) >= 81 and t["x"][0] >= 81 and t["x"][1] >= t["cells"]
    assert plan.stride % plan.cells_per_tile == 0
    assert n ** 3 <= plan.stride < n ** 3 + plan.cells_per_tile
    assert plan.tiles * plan.cells_per_tile == plan.stride
    assert 1 <= plan.grid <= min(plan.tiles, SMS * t["blocks_per_sm"])
    # int32 indexing: the scratch, the row layout and its largest gather,
    # the flat vector (the flat apply runs the same plan)
    rows, W = cm._rows_shape(n)
    assert plan.scratch_numel < 2 ** 31 and rows * W < 2 ** 31
    assert int(cm._u_index(n, torch.device("cpu"), n).max()) < rows * W
    assert 3 * (2 * n + 1) ** 3 < 2 ** 31


def _row_ops(n):
    from poroelasticity_dealii_torch import read_input_file
    from poroelasticity_dealii_torch.solvers.structured import \
        build_grid_discretization
    return build_grid_discretization(
        read_input_file("configs/consolidation_3d.data"), cells_per_axis=n,
        device="cpu").row_ops


def _plain_case(name, n, ro, rng):
    """(input, plain twin's output) of kernel case ``name``."""
    from poroelasticity_dealii_torch.ops import elasticity as eg
    m = ro.free_mask_rows
    u = torch.as_tensor(rng.standard_normal(3 * (2 * n + 1) ** 3))
    x = ro.to_rows(u)
    if name == "coupling_rows":
        p = torch.as_tensor(rng.standard_normal((n + 1) ** 3))
        return p, cm.coupling_rows_plain(p, ro.ce, n)
    if name == "projection_rows":
        return x, cm.projection_rows_plain(x, ro.pe, n)
    if name == "elasticity_grid_apply":
        return u, eg.elasticity_grid_apply_plain(u, ro.ke, n)
    mode = {"unmasked": cm.UNMASKED, "free": cm.FREE,
            "constrained": cm.CONSTRAINED}[name.split("[")[1][:-1]]
    if mode == cm.FREE:
        x = x * m
    return x, cm.elasticity_rows_apply_plain(
        x, None if mode == cm.UNMASKED else m, ro.ke, n, mode)


def _library_case_ids():
    from poroelasticity_dealii_torch.tools import apply_bench
    return apply_bench.LIBRARY_CASES


@pytest.mark.parametrize("name", _library_case_ids())
@pytest.mark.parametrize("n", [2, 3])
def test_csr_yardstick_equals_free_apply(name, n):
    """Every kernel's library yardstick (the FREE apply's and each other
    case's), one CSR operator assembled by tools/apply_bench.library_csr,
    computes what the kernel's plain twin computes (float64, random input with nonzero padding where the layout
    has it, so CONSTRAINED's identity rows are exercised)."""
    from poroelasticity_dealii_torch.tools import apply_bench
    ro = _row_ops(n)
    inp, ref = _plain_case(name, n, ro, np.random.default_rng(n))
    M = apply_bench.library_csr(name, n, ro.ke, ro.ce, ro.pe,
                                ro.free_mask_rows)
    got = torch.mv(M, inp.reshape(-1)).view_as(ref)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-13


@pytest.mark.parametrize("dtype,ctype", [(torch.float32, "float"),
                                         (torch.float64, "double")])
def test_projection_tile_matches_source(dtype, ctype):
    c = _tile_constants(ctype, "kProjRows")
    t = cp.PROJECTION_TILE[dtype]
    assert (c["kCells"], c["kMinBlocks"]) == (t["cells"], t["blocks_per_sm"])
    assert (c["kKRows"], c["kKCols"]) == t["k"]
    assert (c["kXRows"], c["kXStride"]) == t["x"]
    assert (_source_int("kLocal"), _source_int("kVoigt")) == \
        (cp.ELASTICITY_ROWS, cp.N_VOIGT)
    assert 8 * cp.N_VOIGT == cp.PROJECTION_ROWS
    # float32: 12 output rows per warp cover the 48 rows; float64: the
    # 8-row n-tiles of the 16 x 8 x 8 DMMA cover them, b padded to 88
    if dtype == torch.float32:
        assert c["kThreads"] == 32 * cp.PROJECTION_ROWS // 12
        assert t["k"] == (81, cp.PROJECTION_ROWS)
    else:
        assert t["k"][0] == cp.PROJECTION_ROWS and t["k"][0] % 8 == 0
        assert t["k"][1] >= t["x"][0] >= 88
        assert c["kThreads"] == 32 * t["cells"] // 16


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 7, 21, 40, 56, 64])
def test_projection_plan(n, dtype):
    plan = cp.rows_apply_plan(n, dtype, SMS, rows=cp.PROJECTION_ROWS)
    t = cp.PROJECTION_TILE[dtype]
    assert plan.rows == cp.PROJECTION_ROWS
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert t["blocks_per_sm"] * (plan.smem_bytes + 1024) <= SMEM_PER_SM
    assert plan.stride % plan.cells_per_tile == 0
    assert n ** 3 <= plan.stride < n ** 3 + plan.cells_per_tile
    assert plan.tiles * plan.cells_per_tile == plan.stride
    assert 1 <= plan.grid <= min(plan.tiles, SMS * t["blocks_per_sm"])
    assert plan.scratch_numel == cp.PROJECTION_ROWS * plan.stride < 2 ** 31
    # the projection's plan differs from the apply's only in K's shape
    apply = cp.rows_apply_plan(n, dtype, SMS)
    assert (plan.stride, plan.grid) == (apply.stride, apply.grid)
    assert plan.smem_bytes < apply.smem_bytes
    # the sum pass's largest read, row 47 at the last cell, is inside
    assert (cp.PROJECTION_ROWS - 1) * plan.stride + n ** 3 - 1 < \
        plan.scratch_numel


@pytest.mark.parametrize("n", [1, 2, 3, 7, 21, 40, 56, 64])
def test_coupling_launch_geometry(n):
    """One thread per row-layout column (z-half layer zh, lane yh, xh)
    writes that column's 24 rows: the launcher's grid is (n+1) * W threads
    in blocks of kCouplingThreads, and W is a multiple of the block, so the
    grid has no partial block and the row-layout indices fit int32."""
    threads = _source_int("kCouplingThreads")
    rows, W = cm._rows_shape(n)
    assert W % threads == 0
    assert rows * W < 2 ** 31
    text = (CSRC / "comp_major.cu").read_text()
    launch = re.search(r"int launch_coupling\(.*?\n\}", text, re.S).group(0)
    assert re.search(r"blocks_for\(static_cast<long long>\(n \+ 1\) \* W,"
                     r"\s*kCouplingThreads\)", launch)
    assert re.search(r"<<<grid, kCouplingThreads,", launch)


@pytest.mark.parametrize("name,wrapper", [
    ("void (anonymous namespace)::rows_products_kernel<float, 81, false>"
     "(float const*, float const*, float const*, float*, int, int, int)",
     "elasticity_rows_apply"),
    ("rows_products_kernel<double, 81, true>", "elasticity_rows_apply"),
    ("elasticity_rows_sum_kernel<float, 2>", "elasticity_rows_apply"),
    ("rows_products_kernel<float, 48, false>", "projection_rows"),
    ("rows_products_kernel<double, 48, false>", "projection_rows"),
    ("projection_sum_kernel<double>", "projection_rows"),
    ("coupling_rows_kernel<float>", "coupling_rows"),
    # an older tree's names, timed beside this one's by rows_apply_bench
    ("elasticity_rows_products_kernel<float, false>",
     "elasticity_rows_apply"),
    ("projection_rows_kernel<double>", "projection_rows"),
    ("elasticity_grid_apply_kernel<float>", "elasticity_grid_apply"),
    ("elasticity_grid_apply_kernel<double>", "elasticity_grid_apply"),
    ("void at::native::vectorized_elementwise_kernel<4>", None),
    # the shared product pass by layout and row count; the flat node sum
    ("rows_products_kernel<float, 81, false, FlatLayout>",
     "elasticity_grid_apply"),
    ("void (anonymous namespace)::rows_products_kernel<double, 81, false, "
     "(anonymous namespace)::FlatLayout>(double const*, double const*, "
     "double const*, double*, int, int, int)", "elasticity_grid_apply"),
    ("rows_products_kernel<double, 81, false, RowLayout>",
     "elasticity_rows_apply"),
    ("rows_products_kernel<double, 48, false, RowLayout>",
     "projection_rows"),
    ("elasticity_flat_sum_kernel<double>", "elasticity_grid_apply"),
    ("elasticity_flat_sum_kernel<float>", "elasticity_grid_apply"),
])
def test_profiler_groups_kernels_by_wrapper(name, wrapper):
    """tools/profile_step sums each wrapper's CUDA kernels under its name:
    the applies and the projection share the product pass and are told
    apart by its input layout and row count."""
    from poroelasticity_dealii_torch.tools import profile_step
    assert profile_step._wrapper(name) == wrapper


def test_profiler_groups_every_row_kernel_of_the_source():
    """Every __global__ kernel of comp_major.cu belongs to a wrapper."""
    from poroelasticity_dealii_torch.tools import profile_step
    text = (CSRC / "comp_major.cu").read_text()
    kernels = re.findall(r"__global__ void __launch_bounds__\([^;{]*?\)\s*"
                         r"\n(\w+)\(", text)
    assert sorted(kernels) == ["coupling_rows_kernel",
                               "elasticity_flat_sum_kernel",
                               "elasticity_rows_sum_kernel",
                               "projection_sum_kernel",
                               "rows_products_kernel"]
    for k in kernels:
        assert profile_step._wrapper(k) is not None, k


def test_one_product_pass_for_both_layouts():
    """One body of the cell product pass in the sources (the tile products
    once per value type), launched for the row layout (the apply in its
    masked and unmasked forms, the projection) and the flat layout."""
    code = {src.name: re.sub(r"//[^\n]*", "", src.read_text())
            for src in SOURCES}
    allcode = "".join(code.values())
    assert len(re.findall(r"\n(rows_products_kernel)\(", allcode)) == 1
    assert len(re.findall(r"\nelasticity_\w+_kernel\(", allcode)) == 2
    for ctype in ("float", "double"):
        assert len(re.findall(r"void tile_products\(const %s\* ks" % ctype,
                              allcode)) == 1
    launches = re.findall(r"launch_products<T, (\w+), (true|false), "
                          r"(\w+)>", allcode)
    assert sorted(launches) == [("kLocal", "false", "FlatLayout"),
                                ("kLocal", "false", "RowLayout"),
                                ("kLocal", "true", "RowLayout"),
                                ("kProjRows", "false", "RowLayout")]


def _layout_functions(layout: str) -> dict:
    """{name: python function} of the static members of ``struct layout``
    in comp_major.cu, translated from their C integer arithmetic (every
    operand is non-negative, so C's / is Python's //)."""
    text = (CSRC / "comp_major.cu").read_text()
    body = re.search(r"struct %s \{(.*?)\n\};" % layout, text, re.S).group(1)
    out = {}
    for name, params, code in re.findall(
            r"int (\w+)\(([^)]*)\)\s*\{(.*?)\n  \}", body, re.S):
        args = [p.split()[-1] if len(p.split()) > 1 else f"_unused{i}"
                for i, p in enumerate(params.split(","))]
        lines = []
        for stmt in (t.strip() for t in code.split(";") if t.strip()):
            stmt = stmt.replace("/", "//")
            if stmt.startswith("return "):
                lines.append(stmt)
            else:
                assert stmt.startswith("const int "), stmt
                decls = re.split(r",\s*(?=\w+ = )", stmt[len("const int "):])
                lines += decls
        src = "def f(%s):\n    %s\n" % (", ".join(args),
                                          "\n    ".join(lines))
        scope = {}
        exec(src, scope)
        out[name] = scope["f"]
    return out


@pytest.mark.parametrize("n", [2, 3])
def test_flat_layout_offsets_match_cell_gather(n):
    """The flat product pass gathers value b of cell (iz, iy, ix) from
    u[cell_base + node_offset(b)]: those formulas of the source, evaluated
    here for every cell and b, give the flat index that the conv stencil's
    gather (ops/stencil.py::cell_gather) takes for the same entry."""
    from poroelasticity_dealii_torch.ops.stencil import cell_gather
    f = _layout_functions("FlatLayout")
    g = 2 * n + 1
    idx = torch.arange(3 * g ** 3, dtype=torch.float64)
    want = cell_gather(idx, 2, (n, n, n), 3).numpy().astype(np.int64)
    iz, iy, ix = (a.reshape(-1, 1) for a in np.meshgrid(
        *(np.arange(n),) * 3, indexing="ij"))            # cells z, y, x
    b = np.arange(81).reshape(1, -1)
    got = f["cell_base"](iz, iy, ix, n, 0) + f["node_offset"](b, n, 0)
    np.testing.assert_array_equal(got, want)
