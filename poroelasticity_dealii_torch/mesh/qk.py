"""Global Q_k node numbering on a conforming quad/hex mesh.

The deal.II ``DoFHandler::distribute_dofs`` analogue
(``PoroElasticPressureSolver.h:73``, ``PoroElasticDisplacementSolver.h:110``)
rebuilt as vectorized numpy entity dedup: continuity across cells is enforced
topologically (shared vertices / edges / faces get one global node), which is
what guarantees a conforming space without any constraint matrix on uniform
meshes.

Numbering order: mesh vertices first (so Q1 node i == vertex i), then edge
nodes, then (3D) face nodes, then cell-interior nodes.  Deterministic given
cell ordering.

Supported: any degree k in any dim.  3D face-interior nodes (k >= 2) use a
canonical per-face frame anchored at the smallest-id corner so both sharing
cells agree on the (k-1)^2 node grid — the deal.II face-orientation
machinery reduced to a frame convention.  (The reference only ever
instantiates Q1/Q2.)
"""

from __future__ import annotations

import numpy as np

from ..ops.shape import node_lattice, shape_tables
from .core import FESpace, Mesh


def build_fe_space(mesh: Mesh, degree: int) -> FESpace:
    k = degree
    dim = mesh.dim
    if k < 1:
        raise ValueError("degree must be >= 1")

    lat = node_lattice(k, dim)                       # (n_loc, dim)
    n_loc = lat.shape[0]
    n_cells = mesh.n_cells
    cells = mesh.cells.astype(np.int64)              # (n_cells, 2**dim)

    cell_nodes = np.zeros((n_cells, n_loc), dtype=np.int64)
    n_vert = mesh.n_vertices
    next_base = n_vert

    # --- classify local lattice nodes --------------------------------------
    on_hi = lat == k
    on_lo = lat == 0
    on_bnd = on_hi | on_lo
    n_interior_axes = dim - on_bnd.sum(axis=1)

    def corner_index(bits):
        """local corner id from per-axis 0/1 bits (x = bit 0)."""
        return int(sum(int(b) << d for d, b in enumerate(bits)))

    # --- vertex nodes -------------------------------------------------------
    for a in np.nonzero(n_interior_axes == 0)[0]:
        ci = corner_index(on_hi[a])
        cell_nodes[:, a] = cells[:, ci]

    # --- edge nodes (dim >= 2: in 1D an axis-interior node is CELL-interior
    # — counting it here too once orphaned a duplicate node set and made the
    # 1D operator singular) -------------------------------------------------
    edge_base = None
    edge_uid_of = {}
    if k >= 2 and dim >= 2:
        edge_locals = np.nonzero(n_interior_axes == 1)[0]
        if len(edge_locals):
            # collect (endpoint0, endpoint1) global ids per (cell, edge node)
            e0_list, e1_list, t_list = [], [], []
            for a in edge_locals:
                d = int(np.nonzero(~on_bnd[a])[0][0])  # interior axis
                bits0 = on_hi[a].copy(); bits0[d] = False
                bits1 = on_hi[a].copy(); bits1[d] = True
                e0_list.append(cells[:, corner_index(bits0)])
                e1_list.append(cells[:, corner_index(bits1)])
                t_list.append(int(lat[a, d]))
            e0 = np.stack(e0_list, axis=1)   # (n_cells, n_edge_locals)
            e1 = np.stack(e1_list, axis=1)
            t = np.array(t_list)             # (n_edge_locals,)
            lo = np.minimum(e0, e1)
            hi = np.maximum(e0, e1)
            keys = lo * (mesh.n_vertices + 1) + hi  # unique scalar key
            uniq, inv = np.unique(keys.reshape(-1), return_inverse=True)
            inv = inv.reshape(keys.shape)
            # per-edge node offset: position measured from the lower-id end
            offs = np.where(e0 <= e1, t[None, :] - 1, k - 1 - t[None, :])
            gids = next_base + inv * (k - 1) + offs
            for j, a in enumerate(edge_locals):
                cell_nodes[:, a] = gids[:, j]
            # coordinates for unique edge nodes
            lo_u = (uniq // (mesh.n_vertices + 1)).astype(np.int64)
            hi_u = (uniq % (mesh.n_vertices + 1)).astype(np.int64)
            frac = (np.arange(1, k) / k)[None, :, None]
            edge_coords = (mesh.vertices[lo_u][:, None, :] * (1 - frac)
                           + mesh.vertices[hi_u][:, None, :] * frac)
            edge_coords = edge_coords.reshape(-1, dim)
            edge_base = next_base
            next_base += len(uniq) * (k - 1)
        else:
            edge_coords = np.zeros((0, dim))
    else:
        edge_coords = np.zeros((0, dim))

    # --- face-interior nodes (3D only) --------------------------------------
    # Orientation-consistent for ANY k: each unique face gets a CANONICAL
    # (k-1)x(k-1) node grid anchored at its smallest-id corner c0, with the
    # i-axis toward c0's smaller-id face neighbour — both sharing cells
    # derive the same global (i, j) for each physical point, which is the
    # deal.II face-orientation machinery reduced to a frame convention.
    # (k = 2 has a single central node and degenerates to the old rule.)
    face_coords = np.zeros((0, dim))
    if dim == 3 and k >= 2:
        face_locals = np.nonzero(n_interior_axes == 2)[0]
        if len(face_locals):
            m = (k - 1) * (k - 1)
            # unique faces by sorted corner quads (over a canonical set of
            # 6 faces per cell, not per node, for the dedup)
            quads_per_node = []
            geom = []   # per local node: (corner-id arrays p00,p10,p01,p11,
            #             u, v) with u along interior axis d1, v along d2
            for a in face_locals:
                interior = np.sort(np.nonzero(~on_bnd[a])[0])
                d1, d2 = int(interior[0]), int(interior[1])
                ids = {}
                for y0 in (0, 1):
                    for x0 in (0, 1):
                        bits = on_hi[a].copy()
                        bits[d1] = bool(x0)
                        bits[d2] = bool(y0)
                        ids[(x0, y0)] = cells[:, corner_index(bits)]
                geom.append((ids, int(lat[a, d1]), int(lat[a, d2])))
                quads_per_node.append(np.sort(np.stack(
                    [ids[(0, 0)], ids[(1, 0)], ids[(0, 1)], ids[(1, 1)]],
                    axis=1), axis=1))
            flat = np.stack(quads_per_node, axis=1).reshape(-1, 4)
            uniq, inv = np.unique(flat, axis=0, return_inverse=True)
            inv = inv.reshape(n_cells, len(face_locals))

            # canonical (i, j) per (cell, local face node), vectorized
            corner_keys = [(0, 0), (1, 0), (0, 1), (1, 1)]
            # face-graph neighbours of each corner: (along-axis1, along-axis2)
            nbr = {(0, 0): ((1, 0), (0, 1)), (1, 0): ((0, 0), (1, 1)),
                   (0, 1): ((1, 1), (0, 0)), (1, 1): ((0, 1), (1, 0))}
            for j_loc, a in enumerate(face_locals):
                ids, u, v = geom[j_loc]
                g = np.stack([ids[ck] for ck in corner_keys])  # (4, n_cells)
                c0 = np.argmin(g, axis=0)                      # (n_cells,)
                ii = np.zeros(n_cells, np.int64)
                jj = np.zeros(n_cells, np.int64)
                for ci, ck in enumerate(corner_keys):
                    sel = c0 == ci
                    if not sel.any():
                        continue
                    n1, n2 = nbr[ck]
                    ca_is_a1 = ids[n1][sel] < ids[n2][sel]
                    d1c = u if ck[0] == 0 else k - u
                    d2c = v if ck[1] == 0 else k - v
                    ii[sel] = np.where(ca_is_a1, d1c, d2c)
                    jj[sel] = np.where(ca_is_a1, d2c, d1c)
                gid = (next_base + inv[:, j_loc] * m
                       + (jj - 1) * (k - 1) + (ii - 1))
                cell_nodes[:, a] = gid
            # canonical coordinates per unique face: bilinear over the
            # (c0, ca, cb, opposite) frame at (i/k, j/k)
            fc = np.zeros((uniq.shape[0] * m, dim))
            filled = np.zeros(uniq.shape[0], bool)
            for j_loc, a in enumerate(face_locals):
                ids, u, v = geom[j_loc]
                g = np.stack([ids[ck] for ck in corner_keys])
                c0 = np.argmin(g, axis=0)
                for ci, ck in enumerate(corner_keys):
                    sel = np.nonzero((c0 == ci))[0]
                    for e in sel:
                        f = inv[e, j_loc]
                        if filled[f]:
                            continue
                        filled[f] = True
                        n1, n2 = nbr[ck]
                        if ids[n1][e] < ids[n2][e]:
                            ca_k, cb_k = n1, n2
                        else:
                            ca_k, cb_k = n2, n1
                        opp = (1 - ck[0], 1 - ck[1])
                        vc0 = mesh.vertices[ids[ck][e]]
                        vca = mesh.vertices[ids[ca_k][e]]
                        vcb = mesh.vertices[ids[cb_k][e]]
                        vop = mesh.vertices[ids[opp][e]]
                        for jn in range(1, k):
                            for in_ in range(1, k):
                                s, t = in_ / k, jn / k
                                fc[f * m + (jn - 1) * (k - 1) + (in_ - 1)] \
                                    = ((1 - s) * (1 - t) * vc0
                                       + s * (1 - t) * vca
                                       + (1 - s) * t * vcb + s * t * vop)
            face_coords = fc
            next_base += uniq.shape[0] * m

    # --- cell-interior nodes -------------------------------------------------
    int_locals = np.nonzero(n_interior_axes == dim)[0]
    n_int = len(int_locals)
    if n_int:
        gids = next_base + np.arange(n_cells)[:, None] * n_int + np.arange(n_int)
        cell_nodes[:, int_locals] = gids
        # coordinates via isoparametric Q1 map at the lattice points
        ref_pts = lat[int_locals].astype(np.float64) / k * 2.0 - 1.0
        phi1, _ = shape_tables(1, dim, ref_pts)      # (n_int, 2**dim)
        corner_xyz = mesh.vertices[mesh.cells]        # (n_cells, 2**dim, dim)
        int_coords = np.einsum("ic,ecd->eid", phi1, corner_xyz).reshape(-1, dim)
        next_base += n_cells * n_int
    else:
        int_coords = np.zeros((0, dim))

    node_coords = np.concatenate(
        [mesh.vertices, edge_coords, face_coords, int_coords], axis=0)
    assert node_coords.shape[0] == next_base, (node_coords.shape, next_base)

    return FESpace(mesh=mesh, degree=k,
                   node_coords=node_coords,
                   cell_nodes=cell_nodes.astype(np.int32))
