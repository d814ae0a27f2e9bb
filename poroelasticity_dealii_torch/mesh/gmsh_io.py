"""gmsh 2.2 ASCII ``.msh`` reader -> SoA :class:`Mesh`.

The TPU-native replacement for the reference's ``GridIn::read_msh`` path
(``PoroelasticityFSS.h:439-445``, asset ``domain.msh``): quads/hexes become
the cell array, boundary lines/quads with physical tags become boundary faces
with their labels (the deal.II convention of physical-group id == boundary
id, per ``domain.geo:26-30``).

A native C++ fast-path parser may be plugged in via
:mod:`poroelasticity_dealii_tpu.utils.native`; this pure-Python reader is the
always-available reference implementation.
"""

from __future__ import annotations

import numpy as np

from ..ops.shape import face_lattice_indices
from .core import Mesh

# gmsh element type -> (n_nodes, role)
_GMSH_LINE = 1
_GMSH_QUAD = 3
_GMSH_HEX = 5
_GMSH_POINT = 15
_N_NODES = {_GMSH_LINE: 2, _GMSH_QUAD: 4, _GMSH_HEX: 8, _GMSH_POINT: 1,
            2: 3, 4: 4}  # 2=triangle, 4=tet (rejected below)

# gmsh corner ordering -> lexicographic (x fastest) corner ordering
_QUAD_TO_LEX = [0, 1, 3, 2]
_HEX_TO_LEX = [0, 1, 3, 2, 4, 5, 7, 6]


def _parse_sections(text: str):
    sections = {}
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("$") and not line.startswith("$End"):
            name = line[1:]
            j = i + 1
            while j < len(lines) and lines[j].strip() != f"$End{name}":
                j += 1
            if j == len(lines):
                raise ValueError(f"unterminated section {name}")
            sections[name] = lines[i + 1:j]
            i = j + 1
        else:
            i += 1
    return sections


def _parse_python(text: str):
    """Pure-Python gmsh 2.2 parse -> (node_ids, coords3, element lists)."""
    sec = _parse_sections(text)
    if "MeshFormat" not in sec or not sec["MeshFormat"][0].startswith("2.2"):
        raise ValueError("only gmsh 2.2 ASCII format is supported")
    node_lines = sec["Nodes"]
    n_nodes = int(node_lines[0])
    raw = np.array([ln.split() for ln in node_lines[1:1 + n_nodes]],
                   dtype=np.float64)
    node_ids = raw[:, 0].astype(np.int64)
    coords3 = raw[:, 1:4]
    elem_lines = sec["Elements"]
    n_elems = int(elem_lines[0])
    quads, hexes, lines_ = [], [], []
    for ln in elem_lines[1:1 + n_elems]:
        parts = [int(x) for x in ln.split()]
        etype, n_tags = parts[1], parts[2]
        tags = parts[3:3 + n_tags]
        nodes = parts[3 + n_tags:]
        if etype == _GMSH_QUAD:
            quads.append((nodes, tags))
        elif etype == _GMSH_HEX:
            hexes.append((nodes, tags))
        elif etype == _GMSH_LINE:
            lines_.append((nodes, tags))
        elif etype == _GMSH_POINT:
            continue
        else:
            raise ValueError(f"unsupported gmsh element type {etype} "
                             "(only quads/hexes + boundary lines/quads)")
    return node_ids, coords3, quads, hexes, lines_


def _parse_native(path: str):
    """Native-parser fast path; None if the library is unavailable."""
    from ..utils.native import parse_msh_native
    raw = parse_msh_native(path)
    if raw is None:
        return None
    node_ids, coords3, etypes, etag0, conn, offsets = raw
    quads, hexes, lines_ = [], [], []
    for e in range(len(etypes)):
        nodes = conn[offsets[e]:offsets[e + 1]].tolist()
        tags = [int(etag0[e])]
        t = etypes[e]
        if t == _GMSH_QUAD:
            quads.append((nodes, tags))
        elif t == _GMSH_HEX:
            hexes.append((nodes, tags))
        elif t == _GMSH_LINE:
            lines_.append((nodes, tags))
        elif t == _GMSH_POINT:
            continue
        else:
            raise ValueError(f"unsupported gmsh element type {t}")
    return node_ids, coords3, quads, hexes, lines_


def read_msh(path_or_text: str, dim: int | None = None) -> Mesh:
    """Read a gmsh 2.2 ASCII mesh (path or raw text).

    Uses the native C++ parser (utils/native.py) when available for file
    paths; falls back to the pure-Python parser.
    """
    parsed = None
    if not ("\n" in path_or_text or "$MeshFormat" in path_or_text):
        try:
            parsed = _parse_native(path_or_text)
        except ValueError:
            raise
        except Exception:
            parsed = None
        if parsed is None:
            with open(path_or_text) as fh:
                path_or_text = fh.read()
    if parsed is None:
        parsed = _parse_python(path_or_text)
    node_ids, coords3, quads, hexes, lines_ = parsed
    n_nodes = len(node_ids)
    id_to_idx = np.full(node_ids.max() + 1, -1, dtype=np.int64)
    id_to_idx[node_ids] = np.arange(n_nodes)
    inferred_dim = 3 if hexes else 2
    if dim is None:
        dim = inferred_dim
    if dim != inferred_dim:
        raise ValueError(f"mesh is {inferred_dim}D, requested dim={dim}")
    cells = hexes if dim == 3 else quads
    bfaces = quads if dim == 3 else lines_
    if not cells:
        raise ValueError("no quad/hex cells found in mesh")
    perm = _HEX_TO_LEX if dim == 3 else _QUAD_TO_LEX

    vertices = coords3[:, :dim].copy()
    cell_arr = np.array([id_to_idx[np.array(c[0])][perm] for c in cells],
                        dtype=np.int64)

    # fix inverted cells (negative Jacobian): mirror the x axis
    corner_xyz = vertices[cell_arr]                    # (n_cells, 2**dim, dim)
    if dim == 2:
        e1 = corner_xyz[:, 1] - corner_xyz[:, 0]
        e2 = corner_xyz[:, 2] - corner_xyz[:, 0]
        det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    else:
        e1 = corner_xyz[:, 1] - corner_xyz[:, 0]
        e2 = corner_xyz[:, 2] - corner_xyz[:, 0]
        e3 = corner_xyz[:, 4] - corner_xyz[:, 0]
        det = np.einsum("ij,ij->i", np.cross(e1, e2), e3)
    flip = det < 0
    if flip.any():
        swap = ([1, 0, 3, 2] if dim == 2 else [1, 0, 3, 2, 5, 4, 7, 6])
        cell_arr[flip] = cell_arr[flip][:, swap]

    # --- boundary faces: match to (cell, local_face) --------------------------
    face_corner_locals = face_lattice_indices(1, dim)  # local corner ids/face
    key_to_face = {}
    for f_local, loc in enumerate(face_corner_locals):
        keys = np.sort(cell_arr[:, loc], axis=1)
        for c in range(cell_arr.shape[0]):
            key = tuple(keys[c])
            # interior faces appear twice; boundary faces once — keep last,
            # lookups below only ever hit true boundary faces anyway
            key_to_face.setdefault(key, []).append((c, f_local))

    face_cells, face_local, face_ids = [], [], []
    for nodes, tags in bfaces:
        key = tuple(np.sort(id_to_idx[np.array(nodes)]))
        hits = key_to_face.get(key)
        if hits is None or len(hits) != 1:
            if hits is None:
                raise ValueError(f"boundary element {nodes} matches no cell face")
            continue  # facet shared by two cells: interior, skip
        c, fl = hits[0]
        face_cells.append(c)
        face_local.append(fl)
        face_ids.append(tags[0] if tags else 0)

    return Mesh(
        dim=dim,
        vertices=vertices,
        cells=cell_arr.astype(np.int32),
        face_cells=np.asarray(face_cells, dtype=np.int32),
        face_local=np.asarray(face_local, dtype=np.int32),
        face_ids=np.asarray(face_ids, dtype=np.int32),
    )
