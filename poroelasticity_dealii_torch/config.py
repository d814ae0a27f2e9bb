"""Deck-compatible configuration system.

Parses the same parameter-deck grammar the reference reads through
deal.II's ``ParameterHandler`` (``subsection Name`` / ``set Key = value`` /
``end``, ``#`` comments; see reference ``input.data`` and
``lib/include/InputDataPoroel.h:89-147``) into a frozen dataclass with
identical defaults, identical validation bounds, and identical derived
poroelastic moduli (``InputDataPoroel.h:213-222``).

Deliberate differences from the reference (documented, not accidental):

* ``check_data()`` in the reference is entirely commented out
  (``InputDataPoroel.h:225-242``); here the declared ``Patterns`` bounds are
  actually enforced at parse time.
* An optional, *new* ``subsection TPU`` controls dtype / device options the
  reference (a serial CPU code) has no counterpart for.  Decks without it
  parse identically to the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

MILLIDARCY = 9.869233e-16  # m^2 per mD, InputDataPoroel.h:162


# --------------------------------------------------------------------------
# Deck grammar parser (ParameterHandler-compatible subset)
# --------------------------------------------------------------------------

def parse_deck(text: str) -> Dict[Tuple[str, str], str]:
    """Parse ``subsection``/``set``/``end`` deck text.

    Returns a dict mapping ``(subsection, key) -> raw string value``.
    Top-level ``set`` entries use subsection ``""``.  ``#`` starts a comment.
    Mirrors deal.II ParameterHandler text-format semantics for the subset the
    reference uses (single-level subsections, scalar and list values).
    """
    entries: Dict[Tuple[str, str], str] = {}
    stack: List[str] = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        low = line.lower()
        if low.startswith("subsection"):
            name = line[len("subsection"):].strip()
            if not name:
                raise ValueError(f"line {lineno}: subsection without a name")
            stack.append(name)
        elif low == "end":
            if not stack:
                raise ValueError(f"line {lineno}: 'end' without open subsection")
            stack.pop()
        elif low.startswith("set "):
            if "=" not in line:
                raise ValueError(f"line {lineno}: 'set' without '='")
            key, _, value = line[len("set "):].partition("=")
            sub = "/".join(stack)
            entries[(sub, key.strip())] = value.strip()
        else:
            raise ValueError(f"line {lineno}: cannot parse deck line: {raw!r}")
    if stack:
        raise ValueError(f"unterminated subsection(s): {stack}")
    return entries


def _parse_list(value: str, conv) -> list:
    """Comma-separated list -> typed list (InputDataPoroel.h:9-25)."""
    value = value.strip()
    if not value:
        return []
    return [conv(item.strip()) for item in value.split(",")]


# --------------------------------------------------------------------------
# Schema: (subsection, key) -> (default, parser, validator)
# Mirrors declare_parameters(), InputDataPoroel.h:89-147.
# --------------------------------------------------------------------------

def _dbl(lo=None, hi=None):
    def parse(v, name):
        x = float(v)
        if lo is not None and x < lo:
            raise ValueError(f"{name} = {x} below lower bound {lo}")
        if hi is not None and x > hi:
            raise ValueError(f"{name} = {x} above upper bound {hi}")
        return x
    return parse


def _int(lo=None, hi=None):
    def parse(v, name):
        x = int(v)
        if lo is not None and x < lo:
            raise ValueError(f"{name} = {x} below lower bound {lo}")
        if hi is not None and x > hi:
            raise ValueError(f"{name} = {x} above upper bound {hi}")
        return x
    return parse


def _dbl_list(v, name):
    return _parse_list(v, float)


def _int_list(v, name):
    return _parse_list(v, int)


def _str(choices=None):
    def parse(v, name):
        if choices is not None and v not in choices:
            raise ValueError(f"{name} = {v!r} not one of {choices}")
        return v
    return parse


_SCHEMA = {
    # Mesh section (InputDataPoroel.h:91-100)
    ("Mesh", "Dimensions"): ("2", _int(1, 3)),
    ("Mesh", "Domain size"): ("10, 10", _dbl_list),
    ("Mesh", "Initial refinement level"): ("3", _int(2)),
    ("Mesh", "Max refinement level"): ("5", _int(2)),
    ("Mesh", "Mesh file"): ("", _str()),  # gmsh .msh path; "" = structured
    # per-axis structured cell counts "nx, ny[, nz]" (anisotropic grids);
    # "" = 2**initial_refinement_level per axis (reference semantics)
    ("Mesh", "Cells per axis"): ("", _int_list),
    # Properties section (InputDataPoroel.h:101-114)
    ("Properties", "Young modulus"): ("7e9", _dbl(1)),
    ("Properties", "Poisson ratio"): ("0.3", _dbl(0, 0.5)),
    ("Properties", "Biot coefficient"): ("0.9", _dbl(0.1, 1)),
    ("Properties", "Permeability"): ("1", _dbl(1e-20, 1e5)),  # mD
    ("Properties", "Porosity"): ("0.3", _dbl(1e-5, 0.99999)),
    ("Properties", "Viscosity"): ("1e-3", _dbl(1e-6, 1)),
    ("Properties", "Bulk density"): ("2700", _dbl(5e2, 1e4)),
    ("Properties", "Fluid compressibility"): ("45.8e-11", _dbl(1e-16, 1e-2)),
    ("Properties", "Well radius"): ("0.1", _dbl(1e-2)),
    ("Properties", "Flow rate"): ("1e-6", _dbl()),
    # In situ section (InputDataPoroel.h:115-133)
    ("In situ", "Initial pressure"): ("10e6", _dbl(0)),
    ("In situ", "Stress boundary labels"): ("", _int_list),
    ("In situ", "Stress boundary components"): ("", _int_list),
    ("In situ", "Stress boundary values"): ("", _dbl_list),
    ("In situ", "Displacement boundary labels"): ("0, 2, 3, 1", _int_list),
    ("In situ", "Displacement boundary components"): ("1, 1, 0, 0", _int_list),
    ("In situ", "Displacement boundary values"): ("0, 0, 0, -0.1", _dbl_list),
    # Dirichlet pressure (drainage) boundaries — a capability the reference
    # lacks (PoroElasticPressureSolver.h:72 "no dirichlet pressure BC's")
    # but which the Terzaghi/Mandel verification configs require.
    ("In situ", "Pressure boundary labels"): ("", _int_list),
    ("In situ", "Pressure boundary values"): ("", _dbl_list),
    # Solver section (InputDataPoroel.h:134-145)
    ("Solver", "Time step"): ("60", _dbl(1e-8)),
    ("Solver", "Time max"): ("60", _dbl(1e-8)),
    ("Solver", "Max FSS iterations"): ("50", _int(1, 1000)),
    ("Solver", "Max pressure iterations"): ("50", _int(1, 1000)),
    ("Solver", "FSS tolerance"): ("1e-8", _dbl(1e-20, 1e-1)),
    ("Solver", "Pressure tolerance"): ("1e-8", _dbl(1e-20, 1e-1)),
    # TPU section — new (no reference counterpart; serial CPU code)
    ("TPU", "Dtype"): ("float64", _str({"float32", "float64"})),
    ("TPU", "Output directory"): ("./solution", _str()),
    ("TPU", "Output VTK"): ("true", _str({"true", "false"})),
    ("TPU", "Checkpoint every"): ("0", _int(0)),
    # host-sync cadence: with N > 1 the runner dispatches N steps
    # back-to-back (JAX async) and reads stats/logs at sync points only —
    # per-step blocking costs ~35 ms of host round-trip on remote TPUs
    ("TPU", "Sync every"): ("1", _int(1)),
    # step-fusion cadence: with K > 1 the runner executes K time steps as
    # ONE jitted lax.scan dispatch (FixedStressSolver.multi_step) — the
    # per-step host dispatch cost disappears entirely; per-step stats are
    # still logged (read from the stacked block stats).  Divergence/stall
    # detection is deferred to block boundaries, like 'Sync every'.
    # Steps a host consumer reads (VTK cadence, checkpoints) end a block.
    ("TPU", "Steps per dispatch"): ("1", _int(1)),
    ("TPU", "Checkpoint directory"): ("./checkpoints", _str()),
    ("TPU", "Checkpoint format"): ("npz", _str({"npz", "orbax"})),
    # internal similarity rescale of the whole problem to O(1) magnitudes
    # (stress/E, length/L, time/dt) — exact in f64; makes absolute
    # tolerances meaningful in f32; VTK output rescaled back to SI
    # (models/scaling.py)
    ("TPU", "Nondimensionalize"): ("false", _str({"true", "false"})),
    ("TPU", "Refine every"): ("5", _int(0)),  # reference: every 5th step
    ("TPU", "AMR"): ("false", _str({"true", "false"})),
    # Shape bucketing for adaptive runs: pad cells/dofs/constraint tables
    # to geometric size buckets (amr/bucketing.py).  Padding is
    # float-exact (phantom cells carry zero quadrature weight; phantom dofs
    # are pinned to zero).
    ("TPU", "AMR bucketing"): ("true", _str({"true", "false"})),
    # linear-solver tolerances (defaults = the reference's hardcoded values:
    # PoroElasticDisplacementSolver.h:298 abs 1e-12;
    # PoroElasticPressureSolver.h:175 / StrainProjector.h:209 rel 1e-8)
    ("TPU", "Mechanics CG tolerance"): ("1e-12", _dbl(0)),
    ("TPU", "Mechanics CG relative"): ("false", _str({"true", "false"})),
    ("TPU", "Pressure CG tolerance"): ("1e-8", _dbl(0)),
    ("TPU", "Projection CG tolerance"): ("1e-8", _dbl(0)),
    ("TPU", "CG max iterations"): ("1000", _int(1)),
    # Physics-correctness switch.  false (default) = reference-faithful:
    # eps_v evolves only through the fixed-stress predictor and the
    # accumulation term compares against the t=0 strain
    # (PoroelasticityFSS.h:399 commented out + :317 one-time init — SURVEY
    # §2.1.4).  true = textbook fixed-stress Biot: eps_v resynced from the
    # projected mechanical strain each coupling iteration and the
    # accumulation term uses the step-start strain.
    ("TPU", "Volumetric strain resync"): ("false", _str({"true", "false"})),
    # Gravity body force: -9.81 * rho applied on displacement component d.
    # The reference's BodyForces is effectively dead code (default direction
    # 3 is out of range -> zero body force, SURVEY §2.1.2); here -1 (off)
    # replicates that and 0..dim-1 actually enables it.
    ("TPU", "Gravity direction"): ("-1", _int(-1, 2)),
    ("TPU", "Debug NaNs"): ("false", _str({"true", "false"})),
    # Elasticity operator backend on structured grids: 'pallas' runs the
    # mechanics CG in the comp-major row layout through the fused Pallas
    # kernel (ops/pallas_comp_major.py, 3D Q2, TPU only); 'parity' runs it
    # in the 2D parity-class layout (ops/parity2d.py, 2D Q2, any backend);
    # 'conv' keeps the XLA-convolution stencil; 'auto' picks pallas when
    # eligible (3D Q2, equal cells per axis, TPU backend) and parity when
    # eligible and the problem is large enough to matter (2D Q2, equal
    # cells, >= 150k displacement dofs).
    ("TPU", "Elasticity backend"): ("auto", _str({"auto", "conv", "pallas",
                                                  "parity"})),
    # Mechanics CG preconditioner on the row-layout (pallas) path:
    # 'block' couples each node's 3 displacement components through the
    # inverted 3x3 diagonal block of the constrained operator (node-block
    # Jacobi); 'jacobi' is the scalar diagonal.  Default jacobi: on
    # uniform structured grids the assembled interior blocks are EXACTLY
    # diagonal (parity cancellation of the cross-component terms) and the
    # golden decks' Dirichlet masks zero the boundary remainder, so block
    # == jacobi numerically at ~33% more precond bandwidth (measured
    # ablation, docs/VALIDATION.md).  'block' can only pay off on decks
    # whose Neumann/free boundary faces keep all 3 components free.
    ("TPU", "Mechanics preconditioner"): ("jacobi",
                                          _str({"jacobi", "block"})),
    # float64 mechanics via mixed-precision iterative refinement: f64
    # Richardson outer loop whose preconditioner is a full f32 inner solve
    # on the (normalized) residual — f64 accuracy at f32-kernel speed.
    # 'auto' enables it on TPU only (where f64 is emulated and the f64
    # GMG-CG mechanics solve costs ~35 s/step at 40^3 vs ~0.4 s refined);
    # native-f64 CPUs gain nothing.  Structured conv grids only.
    ("TPU", "Mixed precision refinement"): ("auto",
                                            _str({"auto", "on", "off"})),
    # Multi-chip domain decomposition for the runner (parallel/):
    #   none       - single device
    #   psum       - element shard_map + full-vector psum (any mesh, AMR ok)
    #   ghost      - sharded DOF vectors + interface halo ppermutes
    #   gspmd      - conv-stencil GSPMD slab sharding (structured grids)
    #   production - z-slab sharded Pallas row ops + GSPMD stencils
    #                (structured 3D Q2 grids)
    ("TPU", "Sharding"): ("none", _str({"none", "psum", "ghost", "gspmd",
                                        "production"})),
    ("TPU", "Devices"): ("0", _int(0)),   # 0 = all visible devices
}


@dataclasses.dataclass(frozen=True)
class InputData:
    """Typed configuration; field names follow InputDataPoroel.h:46-69."""

    # mesh data
    dim: int
    domain_size: Tuple[float, ...]
    initial_refinement_level: int
    max_refinement_level: int
    mesh_file: str
    # None = 2**initial_refinement_level per axis; else per-axis counts
    cells_per_axis: Optional[Tuple[int, ...]]
    # equation data
    perm: float          # m^2 (converted from mD like InputDataPoroel.h:162-168)
    poro: float
    visc: float
    f_comp: float
    youngs_modulus: float
    poisson_ratio: float
    biot_coef: float
    bulk_density: float
    r_well: float
    flow_rate: float
    # solver control
    time_step: float
    t_max: float
    fss_tol: float
    pressure_tol: float
    max_fss_iterations: int
    max_pressure_iterations: int
    # in situ
    p_init: float
    stress_boundary_labels: Tuple[int, ...]
    stress_boundary_components: Tuple[int, ...]
    stress_boundary_values: Tuple[float, ...]
    displacement_boundary_labels: Tuple[int, ...]
    displacement_boundary_components: Tuple[int, ...]
    displacement_boundary_values: Tuple[float, ...]
    pressure_boundary_labels: Tuple[int, ...] = ()
    pressure_boundary_values: Tuple[float, ...] = ()
    # TPU-native extras
    dtype: str = "float64"
    output_directory: str = "./solution"
    output_vtk: bool = True
    checkpoint_every: int = 0
    checkpoint_directory: str = "./checkpoints"
    checkpoint_format: str = "npz"
    nondimensionalize: bool = False
    sync_every: int = 1
    steps_per_dispatch: int = 1
    refine_every: int = 5
    amr: bool = False
    amr_bucketing: bool = True
    mech_cg_tol: float = 1e-12
    mech_cg_relative: bool = False
    pressure_cg_tol: float = 1e-8
    projection_cg_tol: float = 1e-8
    cg_max_iterations: int = 1000
    resync_volumetric_strain: bool = False
    gravity_direction: int = -1
    debug_nans: bool = False
    elasticity_backend: str = "auto"
    mech_precond: str = "jacobi"
    mixed_precision_refinement: str = "auto"
    sharding: str = "none"
    n_devices: int = 0

    # ---- derived poroelastic moduli (InputDataPoroel.h:213-222) ----
    @property
    def lame_constant(self) -> float:
        E, nu = self.youngs_modulus, self.poisson_ratio
        return E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))

    @property
    def shear_modulus(self) -> float:
        return 0.5 * self.youngs_modulus / (1.0 + self.poisson_ratio)

    @property
    def bulk_modulus(self) -> float:
        return self.lame_constant + 2.0 / 3.0 * self.shear_modulus

    @property
    def grain_bulk_modulus(self) -> float:
        return self.bulk_modulus / (1.0 - self.biot_coef)

    @property
    def n_modulus(self) -> float:
        return self.grain_bulk_modulus / (self.biot_coef - self.poro)

    @property
    def m_modulus(self) -> float:
        n = self.n_modulus
        return (n / self.f_comp) / (n * self.poro + 1.0 / self.f_comp)


def from_entries(entries: Dict[Tuple[str, str], str]) -> InputData:
    """Validate against the schema and build an :class:`InputData`."""
    for key in entries:
        if key not in _SCHEMA:
            raise KeyError(f"unknown deck entry {key[0]!r}/{key[1]!r}")
    vals = {}
    for (sub, key), (default, parse) in _SCHEMA.items():
        raw = entries.get((sub, key), default)
        vals[(sub, key)] = parse(raw, f"{sub}/{key}")

    dsize = vals[("Mesh", "Domain size")]
    dim = vals[("Mesh", "Dimensions")]
    if len(dsize) < dim:
        raise ValueError(f"Domain size has {len(dsize)} entries for dim={dim}")

    data = InputData(
        dim=dim,
        domain_size=tuple(dsize),
        initial_refinement_level=vals[("Mesh", "Initial refinement level")],
        max_refinement_level=vals[("Mesh", "Max refinement level")],
        mesh_file=vals[("Mesh", "Mesh file")],
        cells_per_axis=(tuple(vals[("Mesh", "Cells per axis")])
                        if vals[("Mesh", "Cells per axis")] else None),
        perm=vals[("Properties", "Permeability")] * MILLIDARCY,
        poro=vals[("Properties", "Porosity")],
        visc=vals[("Properties", "Viscosity")],
        f_comp=vals[("Properties", "Fluid compressibility")],
        youngs_modulus=vals[("Properties", "Young modulus")],
        poisson_ratio=vals[("Properties", "Poisson ratio")],
        biot_coef=vals[("Properties", "Biot coefficient")],
        bulk_density=vals[("Properties", "Bulk density")],
        r_well=vals[("Properties", "Well radius")],
        flow_rate=vals[("Properties", "Flow rate")],
        time_step=vals[("Solver", "Time step")],
        t_max=vals[("Solver", "Time max")],
        fss_tol=vals[("Solver", "FSS tolerance")],
        pressure_tol=vals[("Solver", "Pressure tolerance")],
        max_fss_iterations=vals[("Solver", "Max FSS iterations")],
        max_pressure_iterations=vals[("Solver", "Max pressure iterations")],
        p_init=vals[("In situ", "Initial pressure")],
        stress_boundary_labels=tuple(vals[("In situ", "Stress boundary labels")]),
        stress_boundary_components=tuple(vals[("In situ", "Stress boundary components")]),
        stress_boundary_values=tuple(vals[("In situ", "Stress boundary values")]),
        displacement_boundary_labels=tuple(vals[("In situ", "Displacement boundary labels")]),
        displacement_boundary_components=tuple(vals[("In situ", "Displacement boundary components")]),
        displacement_boundary_values=tuple(vals[("In situ", "Displacement boundary values")]),
        pressure_boundary_labels=tuple(vals[("In situ", "Pressure boundary labels")]),
        pressure_boundary_values=tuple(vals[("In situ", "Pressure boundary values")]),
        dtype=vals[("TPU", "Dtype")],
        output_directory=vals[("TPU", "Output directory")],
        output_vtk=vals[("TPU", "Output VTK")] == "true",
        checkpoint_every=vals[("TPU", "Checkpoint every")],
        checkpoint_format=vals[("TPU", "Checkpoint format")],
        nondimensionalize=vals[("TPU", "Nondimensionalize")] == "true",
        sync_every=vals[("TPU", "Sync every")],
        steps_per_dispatch=vals[("TPU", "Steps per dispatch")],
        checkpoint_directory=vals[("TPU", "Checkpoint directory")],
        refine_every=vals[("TPU", "Refine every")],
        amr=vals[("TPU", "AMR")] == "true",
        amr_bucketing=vals[("TPU", "AMR bucketing")] == "true",
        mech_cg_tol=vals[("TPU", "Mechanics CG tolerance")],
        mech_cg_relative=vals[("TPU", "Mechanics CG relative")] == "true",
        pressure_cg_tol=vals[("TPU", "Pressure CG tolerance")],
        projection_cg_tol=vals[("TPU", "Projection CG tolerance")],
        cg_max_iterations=vals[("TPU", "CG max iterations")],
        resync_volumetric_strain=(
            vals[("TPU", "Volumetric strain resync")] == "true"),
        gravity_direction=vals[("TPU", "Gravity direction")],
        debug_nans=vals[("TPU", "Debug NaNs")] == "true",
        elasticity_backend=vals[("TPU", "Elasticity backend")],
        mech_precond=vals[("TPU", "Mechanics preconditioner")],
        mixed_precision_refinement=vals[
            ("TPU", "Mixed precision refinement")],
        sharding=vals[("TPU", "Sharding")],
        n_devices=vals[("TPU", "Devices")],
    )

    nbc = len(data.displacement_boundary_labels)
    if (len(data.displacement_boundary_components) != nbc
            or len(data.displacement_boundary_values) != nbc):
        # the reference constructs-but-never-throws this check
        # (BoundaryConditions.h:34-35); we enforce it.
        raise ValueError("Displacement boundary lists have mismatched lengths")
    nbc = len(data.stress_boundary_labels)
    if (len(data.stress_boundary_components) != nbc
            or len(data.stress_boundary_values) != nbc):
        raise ValueError("Stress boundary lists have mismatched lengths")
    if len(data.pressure_boundary_labels) != len(data.pressure_boundary_values):
        raise ValueError("Pressure boundary lists have mismatched lengths")
    return data


def read_input_file(path: str) -> InputData:
    """Read a deck file; mirrors InputDataPoroel::read_input_file (:77-86)."""
    with open(path, "r") as fh:
        return from_entries(parse_deck(fh.read()))


def format_deck(data: InputData) -> str:
    """Round-trip an InputData back to deck text (ParameterHandler print)."""
    perm_md = data.perm / MILLIDARCY
    fmt_list = lambda xs: ", ".join(str(x) for x in xs)  # noqa: E731
    return "\n".join([
        "subsection Mesh",
        f"  set Dimensions               = {data.dim}",
        f"  set Domain size              = {fmt_list(data.domain_size)}",
        f"  set Initial refinement level = {data.initial_refinement_level}",
        f"  set Max refinement level     = {data.max_refinement_level}",
    ] + ([f"  set Cells per axis           = {fmt_list(data.cells_per_axis)}"]
         if data.cells_per_axis else []) + [
        "end",
        "subsection Properties",
        f"  set Young modulus         = {data.youngs_modulus}",
        f"  set Poisson ratio         = {data.poisson_ratio}",
        f"  set Biot coefficient      = {data.biot_coef}",
        f"  set Permeability          = {perm_md}",
        f"  set Porosity              = {data.poro}",
        f"  set Viscosity             = {data.visc}",
        f"  set Bulk density          = {data.bulk_density}",
        f"  set Fluid compressibility = {data.f_comp}",
        f"  set Well radius           = {data.r_well}",
        f"  set Flow rate             = {data.flow_rate}",
        "end",
        "subsection In situ",
        f"  set Initial pressure                 = {data.p_init}",
        f"  set Stress boundary labels           = {fmt_list(data.stress_boundary_labels)}",
        f"  set Stress boundary components       = {fmt_list(data.stress_boundary_components)}",
        f"  set Stress boundary values           = {fmt_list(data.stress_boundary_values)}",
        f"  set Displacement boundary labels     = {fmt_list(data.displacement_boundary_labels)}",
        f"  set Displacement boundary components = {fmt_list(data.displacement_boundary_components)}",
        f"  set Displacement boundary values     = {fmt_list(data.displacement_boundary_values)}",
        f"  set Pressure boundary labels         = {fmt_list(data.pressure_boundary_labels)}",
        f"  set Pressure boundary values         = {fmt_list(data.pressure_boundary_values)}",
        "end",
        "subsection Solver",
        f"  set Time step               = {data.time_step}",
        f"  set Time max                = {data.t_max}",
        f"  set Max FSS iterations      = {data.max_fss_iterations}",
        f"  set Max pressure iterations = {data.max_pressure_iterations}",
        f"  set FSS tolerance           = {data.fss_tol}",
        f"  set Pressure tolerance      = {data.pressure_tol}",
        "end",
        "subsection TPU",
        f"  set Dtype                    = {data.dtype}",
        f"  set Output directory         = {data.output_directory}",
        f"  set Output VTK               = {'true' if data.output_vtk else 'false'}",
        f"  set Volumetric strain resync = "
        f"{'true' if data.resync_volumetric_strain else 'false'}",
        f"  set AMR                      = {'true' if data.amr else 'false'}",
        f"  set Gravity direction        = {data.gravity_direction}",
        "end",
    ]) + "\n"
