"""The port keeps its own copies of the JAX package's host modules
(``config``, ``mesh/`` with the gmsh reader ``mesh/gmsh_io.py``,
``ops/shape.py``, ``ops/quadrature.py``, ``utils/logging_utils.py``,
``utils/native.py``, ``models/terzaghi.py``, ``models/mandel.py``,
``models/cryer.py``, ``models/scaling.py``, the AMR forests, Kelly
indicator and transfer
``amr/{forest,octforest,kelly,transfer,multiroot,multiroot3d}.py``, the
four hanging-node builders of ``amr/constraints.py``, the node-block
assembly ``ops/node_blocks.py`` and the scipy oracle ``validation.py``)
and imports nothing of the JAX package.

* No import line of the port or ``chip_smoke.py`` names the JAX package
  (``tests/test_torch_nojax.py`` checks in a fresh interpreter that none
  of it is loaded).
* The copies agree with the originals exactly: every deck in ``configs/``
  parses to equal fields, and the shape, quadrature, lattice, mesh and
  structured-space arrays are bitwise equal, for dims 2 and 3 and degrees
  1 and 2; the analytic models' and the gmsh reader's sources equal the
  originals but for their relative imports, their configurations, series
  and meshes are equal, and ``read_msh`` reads both gmsh assets in
  ``configs/`` to equal meshes; the AMR modules' sources equal the
  originals but for their relative imports (and the reference checkout's
  directory, left out of two docstrings), and the constraint builders'
  and their helpers' sources equal the originals; ``ops/node_blocks.py``
  holds ``elasticity_node_blocks`` of ``ops/pallas_comp_major.py`` and
  nothing else.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

from poroelasticity_dealii_torch import config as tconfig
from poroelasticity_dealii_torch.mesh import generator as tgen
from poroelasticity_dealii_torch.mesh import qk as tqk
from poroelasticity_dealii_torch.mesh import structured as tstr
from poroelasticity_dealii_torch.ops import quadrature as tquad
from poroelasticity_dealii_torch.ops import shape as tshape

REPO = Path(__file__).resolve().parent.parent
DECKS = sorted(p.name for p in (REPO / "configs").glob("*.data"))


def test_no_import_line_names_the_jax_package():
    files = list((REPO / "poroelasticity_dealii_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for f in files:
        for line in f.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert "poroelasticity_dealii_tpu" not in line, (f, line)


@pytest.mark.parametrize("msh,dim", [("irregular_2d.msh", 2),
                                     ("irregular_3d.msh", 3)])
def test_read_msh_equals_jax(msh, dim):
    """Both packages read the gmsh asset to equal meshes, from its path
    (the native parser when it builds) and from its text (the pure-Python
    parser)."""
    from poroelasticity_dealii_torch.mesh import read_msh
    from poroelasticity_dealii_tpu.mesh import read_msh as jread_msh
    path = str(REPO / "configs" / msh)
    text = Path(path).read_text()
    want = jread_msh(path, dim=dim)
    assert want.n_cells > 0
    for got in (read_msh(path, dim=dim), read_msh(text, dim=dim),
                jread_msh(text, dim=dim)):
        for f in dataclasses.fields(want):
            _eq(getattr(got, f.name), getattr(want, f.name))


@pytest.mark.parametrize("deck", DECKS)
def test_deck_parse_equals_jax(deck):
    from poroelasticity_dealii_tpu import config as jconfig
    path = str(REPO / "configs" / deck)
    got, want = tconfig.read_input_file(path), jconfig.read_input_file(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tconfig.format_deck(got) == jconfig.format_deck(want)
    # derived moduli come from the same formulas
    for name in ("lame_constant", "shear_modulus", "bulk_modulus",
                 "m_modulus"):
        assert getattr(got, name) == getattr(want, name)


def test_tpu_subsection_parses_like_jax():
    from poroelasticity_dealii_tpu import config as jconfig
    text = ((REPO / "configs" / "consolidation_3d.data").read_text()
            + "\nsubsection TPU\n  set Elasticity backend = conv\n"
              "  set Dtype = float32\nend\n")
    assert tconfig.parse_deck(text) == jconfig.parse_deck(text)
    got = tconfig.from_entries(tconfig.parse_deck(text))
    want = jconfig.from_entries(jconfig.parse_deck(text))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.elasticity_backend, got.dtype) == ("conv", "float32")
    bad = text.replace("Dtype", "No such key")
    for mod in (tconfig, jconfig):
        with pytest.raises(KeyError, match="No such key"):
            mod.from_entries(mod.parse_deck(bad))


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dim,degree", [(2, 1), (2, 2), (3, 1), (3, 2)])
def test_host_arrays_bitwise_equal_jax(dim, degree):
    from poroelasticity_dealii_tpu.mesh import generator as jgen
    from poroelasticity_dealii_tpu.mesh import qk as jqk
    from poroelasticity_dealii_tpu.mesh import structured as jstr
    from poroelasticity_dealii_tpu.ops import quadrature as jquad
    from poroelasticity_dealii_tpu.ops import shape as jshape

    for nq in (degree + 1, degree + 2):
        for a, b in zip(tquad.gauss_tensor(nq, dim),
                        jquad.gauss_tensor(nq, dim)):
            _eq(a, b)
    pts, _ = jquad.gauss_tensor(degree + 1, dim)
    for a, b in zip(tshape.shape_tables(degree, dim, pts),
                    jshape.shape_tables(degree, dim, pts)):
        _eq(a, b)
    _eq(tshape.node_lattice(degree, dim), jshape.node_lattice(degree, dim))
    for a, b in zip(tshape.face_lattice_indices(degree, dim),
                    jshape.face_lattice_indices(degree, dim)):
        _eq(a, b)

    size = (10.0, 7.0, 5.0)[:dim]
    cells = (3, 2, 4)[:dim]
    for got, want in ((tgen.hyper_rectangle(size, cells_per_axis=cells),
                       jgen.hyper_rectangle(size, cells_per_axis=cells)),
                      (tgen.hyper_rectangle(size, refinement_level=2),
                       jgen.hyper_rectangle(size, refinement_level=2))):
        for f in dataclasses.fields(want):
            _eq(getattr(got, f.name), getattr(want, f.name))
    mesh_t = tstr.structured_mesh(size, cells)
    mesh_j = jstr.structured_mesh(size, cells)
    (sp_t, info_t) = tstr.build_structured_space(mesh_t, cells, degree)
    (sp_j, info_j) = jstr.build_structured_space(mesh_j, cells, degree)
    assert dataclasses.asdict(info_t) == dataclasses.asdict(info_j)
    for name in ("node_coords", "cell_nodes"):
        _eq(getattr(sp_t, name), getattr(sp_j, name))
    fe_t, fe_j = tqk.build_fe_space(mesh_t, degree), \
        jqk.build_fe_space(mesh_j, degree)
    for name in ("node_coords", "cell_nodes"):
        _eq(getattr(fe_t, name), getattr(fe_j, name))


MODELS = ("terzaghi", "mandel", "cryer")
# host modules copied with no change but their relative imports
HOST_COPIES = ("mesh/gmsh_io.py", "utils/native.py", "amr/forest.py",
               "amr/octforest.py", "amr/kelly.py", "amr/transfer.py",
               "amr/multiroot.py", "amr/multiroot3d.py", "models/scaling.py",
               "validation.py", "ops/node_blocks.py")
# copies of functions of a JAX module that imports jax: the port module
# holds exactly these functions, each source-equal to the original
FUNCTION_COPIES = {
    "ops/node_blocks.py": ("ops/pallas_comp_major.py",
                           ("elasticity_node_blocks",))}
# the numpy functions of amr/constraints.py, copied as they are (the
# tables' class, its empty instance and _pack_rows's return are the port's)
CONSTRAINT_BUILDERS = (
    "build_hanging_constraints", "build_hanging_constraints_geometric",
    "build_hanging_constraints_3d_entities",
    "build_hanging_constraints_from_edges", "_q2_edge_triples",
    "_edge_midnode_map", "_q2_face_centers", "_face_center_map",
    "_resolve_chains", "_lagrange_q2_1d")


def _code_lines(path: Path) -> list:
    """The source's lines, its relative import lines left out, and an
    absolute directory before a file name in a literal (the reference's
    checkout in a docstring) dropped."""
    return [re.sub(r"``/[^`]*/([^/`]+)``", r"``\1``", ln)
            for ln in path.read_text().splitlines()
            if not ln.startswith("from .")]


@pytest.mark.parametrize("name", MODELS)
def test_model_copies_equal_jax_source(name):
    got = REPO / "poroelasticity_dealii_torch" / "models" / f"{name}.py"
    want = REPO / "poroelasticity_dealii_tpu" / "models" / f"{name}.py"
    assert _code_lines(got) == _code_lines(want)


def _function_sources(path: Path) -> dict:
    """{name: source} of the module's top-level functions."""
    import ast
    text = path.read_text()
    return {node.name: ast.get_source_segment(text, node)
            for node in ast.parse(text).body
            if isinstance(node, ast.FunctionDef)}


@pytest.mark.parametrize("rel", HOST_COPIES)
def test_host_copies_equal_jax_source(rel):
    got = REPO / "poroelasticity_dealii_torch" / rel
    if rel in FUNCTION_COPIES:
        src, names = FUNCTION_COPIES[rel]
        want = _function_sources(REPO / "poroelasticity_dealii_tpu" / src)
        assert _function_sources(got) == {k: want[k] for k in names}
        return
    want = REPO / "poroelasticity_dealii_tpu" / rel
    assert _code_lines(got) == _code_lines(want)


@pytest.mark.parametrize("name", CONSTRAINT_BUILDERS)
def test_constraint_builders_equal_jax_source(name):
    import inspect

    from poroelasticity_dealii_torch.amr import constraints as tc
    from poroelasticity_dealii_tpu.amr import constraints as jc
    assert inspect.getsource(getattr(tc, name)) == \
        inspect.getsource(getattr(jc, name))


def test_cryer_copy_computes_what_jax_computes():
    from poroelasticity_dealii_torch.models import cryer as tc
    from poroelasticity_dealii_tpu.models import cryer as jc
    got, want = tc.cryer_config(dt=1.25), jc.cryer_config(dt=1.25)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    cp_t = tc.cryer_params(got, radius=10.0, load=7.2e6)
    cp_j = jc.cryer_params(want, radius=10.0, load=7.2e6)
    for a, b in zip(cp_t, cp_j):
        _eq(a, b)
    r = np.linspace(0.0, 10.0, 21)
    for t in (1.25, 25.0, 125.0):
        _eq(tc.cryer_pressure(r, t, cp_t), jc.cryer_pressure(r, t, cp_j))
    _eq(tc.cryer_center_pressure([1.25, 25.0], cp_t),
        jc.cryer_center_pressure([1.25, 25.0], cp_j))
    mt, mj = tc.cryer_mesh(10.0, 4), jc.cryer_mesh(10.0, 4)
    for f in dataclasses.fields(mj):
        _eq(getattr(mt, f.name), getattr(mj, f.name))


def test_model_copies_compute_what_jax_computes():
    from poroelasticity_dealii_torch.models import mandel as tm
    from poroelasticity_dealii_torch.models import terzaghi as tt
    from poroelasticity_dealii_tpu.models import mandel as jm
    from poroelasticity_dealii_tpu.models import terzaghi as jt
    for level, dt, resync in ((3, 25.0, True), (4, 12.5, False)):
        got = tt.terzaghi_config(level=level, dt=dt, resync=resync)
        want = jt.terzaghi_config(level=level, dt=dt, resync=resync)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        cv = tt.consolidation_coefficient(got)
        assert cv == jt.consolidation_coefficient(want)
        z = np.linspace(0.0, 10.0, 17)
        _eq(tt.terzaghi_pressure(z, 250.0, cv, 10.0, 1e5),
            jt.terzaghi_pressure(z, 250.0, cv, 10.0, 1e5))
        _eq(tt.quirk_mode_1d_reference(1e5, 17, 10.0, got, dt, 3),
            jt.quirk_mode_1d_reference(1e5, 17, 10.0, want, dt, 3))
    got = tm.mandel_config(a=10.0, level=4, dt=5.0)
    want = jm.mandel_config(a=10.0, level=4, dt=5.0)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    mp_t = tm.mandel_params(got, a=10.0, b=10.0, force=7.2e6)
    mp_j = jm.mandel_params(want, a=10.0, b=10.0, force=7.2e6)
    for a, b in zip(mp_t, mp_j):
        _eq(a, b)
    x = np.linspace(0.0, 10.0, 33)
    for t in (1.0, 50.0, 400.0):
        _eq(tm.mandel_pressure(x, t, mp_t), jm.mandel_pressure(x, t, mp_j))
        assert tm.mandel_plate_displacement(t, mp_t) == \
            jm.mandel_plate_displacement(t, mp_j)
