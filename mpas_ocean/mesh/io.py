"""MPAS-convention NetCDF mesh/state file reading and writing.

Read side mirrors the reference's mesh ingestion (reference:
src/infra/MPASMesh/HorzMesh.jl:166-355 `readPrimaryMesh`/`readDualMesh`/
`readEdgeInfo`/`ReadHorzMesh` and src/infra/MPASMesh/VertMesh.jl:46-90
`VerticalMesh`): standard MPAS variable names, 1-based 0-padded connectivity
in the file converted here to the framework's 0-based masked layout
(SURVEY quirk 7.9). Write side persists generated meshes + initial states in
the same convention, so files round-trip and stay interoperable with MPAS
tooling.

Array order note: MPAS files are written by Fortran, so a numpy read of e.g.
edgesOnCell yields (nCells, maxEdges) with the neighbor axis trailing —
exactly this framework's layout.
"""

from __future__ import annotations

import numpy as np

from ..infra.netcdf import NCData, read_netcdf, write_netcdf
from .horz_mesh import DualCells, Edges, HorzMesh, PrimaryCells
from .mesh import Mesh
from .vert_mesh import VerticalMesh, make_vertical_mesh

__all__ = ["read_mpas_mesh", "save_mpas_mesh", "read_initial_state"]


def _to_zero_based(conn: np.ndarray) -> np.ndarray:
    """1-based 0-padded MPAS connectivity -> 0-based with pad slots at 0."""
    return np.where(conn > 0, conn - 1, 0).astype(np.int32)


def _slot_mask(counts: np.ndarray, width: int) -> np.ndarray:
    return (np.arange(width)[None, :] < counts[:, None])


def read_mpas_mesh(path, dtype=np.float64) -> HorzMesh:
    """Read an MPAS-format NetCDF mesh file into a HorzMesh."""
    ds = read_netcdf(path)
    return horz_mesh_from_ncdata(ds, dtype=dtype)


def horz_mesh_from_ncdata(ds: NCData, dtype=np.float64) -> HorzMesh:
    n_cells = ds.dims["nCells"]
    n_edges = ds.dims["nEdges"]
    n_vertices = ds.dims["nVertices"]
    max_edges = ds.dims["maxEdges"]
    vertex_degree = ds.dims["vertexDegree"]

    def var(name, default=None):
        if name in ds:
            return np.asarray(ds[name])
        if default is not None:
            return default
        raise KeyError(f"mesh file missing required variable {name!r}")

    n_edges_on_cell = var("nEdgesOnCell").astype(np.int32)
    mask_c = _slot_mask(n_edges_on_cell, max_edges)

    edges_on_cell = _to_zero_based(var("edgesOnCell"))
    vertices_on_cell = _to_zero_based(var("verticesOnCell"))
    cells_on_cell = _to_zero_based(var("cellsOnCell"))
    cells_on_edge = _to_zero_based(var("cellsOnEdge"))
    vertices_on_edge = _to_zero_based(var("verticesOnEdge"))
    cells_on_vertex = _to_zero_based(var("cellsOnVertex"))
    edges_on_vertex = _to_zero_based(var("edgesOnVertex"))
    edges_on_edge = _to_zero_based(var("edgesOnEdge"))
    n_edges_on_edge = var("nEdgesOnEdge").astype(np.int32)
    weights_on_edge = var("weightsOnEdge").astype(dtype)

    # derived sign fields (reference: HorzMesh.jl:292-332), with the pad
    # mask folded in as 0.0
    cell_ids = np.arange(n_cells, dtype=np.int32)[:, None]
    edge_sign_on_cell = np.where(
        mask_c,
        np.where(cells_on_edge[edges_on_cell, 0] == cell_ids, -1.0, 1.0),
        0.0,
    ).astype(dtype)
    vert_ids = np.arange(n_vertices, dtype=np.int32)[:, None]
    # padded edgesOnVertex slots (0 in the 1-based file — boundary vertices
    # of culled meshes) must carry sign 0.0, not a spurious +-1: the curl at
    # those vertices would otherwise pick up edge 0's velocity
    eov_valid = var("edgesOnVertex") > 0
    edge_sign_on_vertex = np.where(
        eov_valid
        & (vertices_on_edge[edges_on_vertex, 0] == vert_ids),
        -1.0,
        np.where(eov_valid, 1.0, 0.0),
    ).astype(dtype)

    kite_v = var(
        "kiteAreasOnVertex", np.zeros((n_vertices, vertex_degree))
    ).astype(dtype)
    # cell-frame kites recovered by matching cellsOnVertex (used only by
    # weight (re)generation; zero when absent)
    kite_c = np.zeros((n_cells, max_edges), dtype=dtype)
    voc = vertices_on_cell
    for j in range(vertex_degree):
        match = cells_on_vertex[voc, j] == cell_ids
        kite_c = np.where(match & mask_c, kite_v[voc, j], kite_c)

    boundary_edge = var("boundaryEdge", np.zeros(n_edges))
    if boundary_edge.ndim == 2:  # (nEdges, nVertLevels) in some files
        boundary_edge = boundary_edge[:, 0]

    zeros_c = np.zeros(n_cells)
    zeros_e = np.zeros(n_edges)
    zeros_v = np.zeros(n_vertices)

    cells = PrimaryCells(
        n_cells=n_cells,
        max_edges=max_edges,
        x=var("xCell").astype(dtype),
        y=var("yCell").astype(dtype),
        z=var("zCell", zeros_c).astype(dtype),
        f=var("fCell", zeros_c).astype(dtype),
        area_cell=var("areaCell").astype(dtype),
        n_edges_on_cell=n_edges_on_cell,
        edges_on_cell=np.where(mask_c, edges_on_cell, 0),
        vertices_on_cell=np.where(mask_c, vertices_on_cell, 0),
        cells_on_cell=np.where(mask_c, cells_on_cell, 0),
        edge_sign_on_cell=edge_sign_on_cell,
        edge_mask_on_cell=mask_c.astype(dtype),
        kite_areas_on_cell=kite_c,
    )
    duals = DualCells(
        n_vertices=n_vertices,
        vertex_degree=vertex_degree,
        x=var("xVertex").astype(dtype),
        y=var("yVertex").astype(dtype),
        z=var("zVertex", zeros_v).astype(dtype),
        f=var("fVertex", zeros_v).astype(dtype),
        area_triangle=var("areaTriangle").astype(dtype),
        edges_on_vertex=edges_on_vertex,
        cells_on_vertex=cells_on_vertex,
        edge_sign_on_vertex=edge_sign_on_vertex,
        kite_areas_on_vertex=kite_v,
    )
    edges = Edges(
        n_edges=n_edges,
        max_edges2=edges_on_edge.shape[1],
        x=var("xEdge").astype(dtype),
        y=var("yEdge").astype(dtype),
        z=var("zEdge", zeros_e).astype(dtype),
        f=var("fEdge", zeros_e).astype(dtype),
        cells_on_edge=cells_on_edge,
        vertices_on_edge=vertices_on_edge,
        n_edges_on_edge=n_edges_on_edge,
        edges_on_edge=edges_on_edge,
        weights_on_edge=weights_on_edge,
        dv_edge=var("dvEdge").astype(dtype),
        dc_edge=var("dcEdge").astype(dtype),
        angle_edge=var("angleEdge").astype(dtype),
        edge_mask=(boundary_edge == 0).astype(dtype),
    )

    on_sphere = str(ds.attrs.get("on_a_sphere", "NO")).upper().startswith("Y")
    return HorzMesh(
        cells=cells,
        duals=duals,
        edges=edges,
        lx=float(ds.attrs.get("x_period", 0.0)),
        ly=float(ds.attrs.get("y_period", 0.0)),
        on_sphere=on_sphere,
        sphere_radius=float(ds.attrs.get("sphere_radius", 0.0)),
    )


def vertical_mesh_from_ncdata(
    ds: NCData, horz: HorzMesh, dtype=np.float64
) -> VerticalMesh:
    """Vertical mesh from the same file (reference: VertMesh.jl:46-90)."""
    n_vert_levels = ds.dims.get("nVertLevels", 1)
    n_cells = horz.n_cells
    if "minLevelCell" in ds:
        min_level = np.asarray(ds["minLevelCell"]).astype(np.int32) - 1
    else:
        min_level = np.zeros(n_cells, dtype=np.int32)
    if "maxLevelCell" in ds:
        max_level = np.asarray(ds["maxLevelCell"]).astype(np.int32)
    else:
        max_level = np.full(n_cells, n_vert_levels, dtype=np.int32)
    if "restingThickness" in ds:
        rt = np.asarray(ds["restingThickness"])
        if rt.ndim == 3:  # (Time, nCells, nVertLevels)
            rt = rt[0]
    else:
        rt = np.ones((n_cells, n_vert_levels))
    bottom_depth = (
        np.asarray(ds["bottomDepth"]) if "bottomDepth" in ds else None
    )
    vcmw = (
        np.asarray(ds["vertCoordMovementWeights"])
        if "vertCoordMovementWeights" in ds
        else None
    )
    return make_vertical_mesh(
        horz,
        n_vert_levels=n_vert_levels,
        resting_thickness=rt,
        min_level_cell=min_level,
        max_level_cell=max_level,
        dtype=dtype,
        bottom_depth=bottom_depth,
        vert_coord_movement_weights=vcmw,
    )


def read_initial_state(path, n_vert_levels: int):
    """Read (ssh, layerThickness, normalVelocity) from an input-stream file
    (reference: PrognosticVars.jl:85-99)."""
    ds = read_netcdf(path)

    def first_time(name):
        a = np.asarray(ds[name])
        # state variables carry a leading Time dimension
        expected_ndim = 2 if name == "ssh" else 3
        if a.ndim == expected_ndim:
            a = a[0]
        return a

    ssh = first_time("ssh")
    h = first_time("layerThickness")
    u = first_time("normalVelocity")
    assert h.shape[1] == n_vert_levels and u.shape[1] == n_vert_levels
    return ssh, h, u


def read_tracers(path, names, n_cells: int, n_vert_levels: int) -> np.ndarray:
    """Read named tracer fields (temperature, salinity, ...) from an
    input/restart-stream file into the (nCells, nT, K) tracer array
    (models/tracers.py). Each variable may be (nCells,), (nCells, K) or
    carry a leading Time dimension; (nCells,) replicates over levels.

    (The reference stubs these state slots out, reference:
    src/ocn/PrognosticVars.jl:20-26.)
    """
    ds = read_netcdf(path)
    cols = []
    for name in names:
        if name not in ds:
            raise KeyError(
                f"tracer variable {name!r} not found in {path!r} "
                f"(have: {sorted(k for k in ds)})"
            )
        a = np.asarray(ds[name])
        if a.ndim == 3 or (a.ndim == 2 and a.shape[0] != n_cells):
            a = a[0]  # drop leading Time
        if a.ndim == 1:
            a = np.repeat(a[:, None], n_vert_levels, axis=1)
        if a.shape != (n_cells, n_vert_levels):
            raise ValueError(
                f"tracer {name!r} has shape {a.shape}; expected "
                f"({n_cells},) or ({n_cells}, {n_vert_levels})"
            )
        cols.append(a)
    return np.stack(cols, axis=1)


def save_mpas_mesh(
    path,
    mesh: Mesh | HorzMesh,
    initial_state: tuple | None = None,
    cell_fields: dict | None = None,
) -> None:
    """Write a mesh (+ optional (ssh, h, u) initial state) as an
    MPAS-convention NetCDF file usable as both the `mesh` and `input`
    streams of a model config. ``cell_fields`` adds named per-cell state
    variables (tracers: temperature, salinity, ...), each (nCells,) or
    (nCells, nVertLevels), written with a leading Time dimension."""
    if isinstance(mesh, Mesh):
        horz, vert = mesh.horz, mesh.vert
    else:
        horz, vert = mesh, None

    c, d, e = horz.cells, horz.duals, horz.edges
    np_ = lambda a: np.asarray(a)

    def one_based(conn, mask=None):
        conn = np_(conn).astype(np.int32) + 1
        if mask is not None:
            conn = np.where(np_(mask) > 0, conn, 0)
        return conn

    dims = {
        "nCells": horz.n_cells,
        "nEdges": horz.n_edges,
        "nVertices": horz.n_vertices,
        "maxEdges": c.max_edges,
        "maxEdges2": e.max_edges2,
        "TWO": 2,
        "vertexDegree": d.vertex_degree,
        "Time": 1,
    }
    f64 = np.float64
    from .sphere import latlon_from_xyz

    def latlon(elem, dim):
        if horz.on_sphere:
            lat, lon = latlon_from_xyz(elem.x, elem.y, elem.z)
        else:
            lat = lon = np.zeros(np.asarray(elem.x).shape)
        return lat.astype(f64), lon.astype(f64), dim

    latc, lonc, _ = latlon(c, "nCells")
    late, lone, _ = latlon(e, "nEdges")
    latv, lonv, _ = latlon(d, "nVertices")
    variables = {
        "xCell": (("nCells",), np_(c.x).astype(f64)),
        "yCell": (("nCells",), np_(c.y).astype(f64)),
        "zCell": (("nCells",), np_(c.z).astype(f64)),
        "latCell": (("nCells",), latc),
        "lonCell": (("nCells",), lonc),
        "latEdge": (("nEdges",), late),
        "lonEdge": (("nEdges",), lone),
        "latVertex": (("nVertices",), latv),
        "lonVertex": (("nVertices",), lonv),
        "fCell": (("nCells",), np_(c.f).astype(f64)),
        "areaCell": (("nCells",), np_(c.area_cell).astype(f64)),
        "nEdgesOnCell": (("nCells",), np_(c.n_edges_on_cell).astype(np.int32)),
        "edgesOnCell": (
            ("nCells", "maxEdges"),
            one_based(c.edges_on_cell, c.edge_mask_on_cell),
        ),
        "verticesOnCell": (
            ("nCells", "maxEdges"),
            one_based(c.vertices_on_cell, c.edge_mask_on_cell),
        ),
        "cellsOnCell": (
            ("nCells", "maxEdges"),
            one_based(c.cells_on_cell, c.edge_mask_on_cell),
        ),
        "xEdge": (("nEdges",), np_(e.x).astype(f64)),
        "yEdge": (("nEdges",), np_(e.y).astype(f64)),
        "zEdge": (("nEdges",), np_(e.z).astype(f64)),
        "fEdge": (("nEdges",), np_(e.f).astype(f64)),
        "dvEdge": (("nEdges",), np_(e.dv_edge).astype(f64)),
        "dcEdge": (("nEdges",), np_(e.dc_edge).astype(f64)),
        "angleEdge": (("nEdges",), np_(e.angle_edge).astype(f64)),
        "cellsOnEdge": (("nEdges", "TWO"), one_based(e.cells_on_edge)),
        "verticesOnEdge": (("nEdges", "TWO"), one_based(e.vertices_on_edge)),
        "nEdgesOnEdge": (("nEdges",), np_(e.n_edges_on_edge).astype(np.int32)),
        "edgesOnEdge": (
            ("nEdges", "maxEdges2"),
            np.where(
                np.abs(np_(e.weights_on_edge)) > 0,
                np_(e.edges_on_edge).astype(np.int32) + 1,
                0,
            ),
        ),
        "weightsOnEdge": (
            ("nEdges", "maxEdges2"),
            np_(e.weights_on_edge).astype(f64),
        ),
        "boundaryEdge": (
            ("nEdges",),
            (np_(e.edge_mask) == 0).astype(np.int32),
        ),
        "xVertex": (("nVertices",), np_(d.x).astype(f64)),
        "yVertex": (("nVertices",), np_(d.y).astype(f64)),
        "zVertex": (("nVertices",), np_(d.z).astype(f64)),
        "fVertex": (("nVertices",), np_(d.f).astype(f64)),
        "areaTriangle": (("nVertices",), np_(d.area_triangle).astype(f64)),
        "cellsOnVertex": (
            ("nVertices", "vertexDegree"),
            one_based(d.cells_on_vertex),
        ),
        "edgesOnVertex": (
            ("nVertices", "vertexDegree"),
            # dead slots (sign 0.0 — boundary vertices of culled meshes)
            # must round-trip as 0-pads, or a reread mesh regains phantom
            # curl contributions from edge 1
            one_based(d.edges_on_vertex, np.abs(np_(d.edge_sign_on_vertex))),
        ),
        "kiteAreasOnVertex": (
            ("nVertices", "vertexDegree"),
            np_(d.kite_areas_on_vertex).astype(f64),
        ),
    }

    if vert is not None:
        dims["nVertLevels"] = vert.n_vert_levels
        variables.update(
            {
                "minLevelCell": (
                    ("nCells",),
                    np_(vert.min_level_cell).astype(np.int32) + 1,
                ),
                "maxLevelCell": (
                    ("nCells",),
                    np_(vert.max_level_cell).astype(np.int32),
                ),
                "restingThickness": (
                    ("Time", "nCells", "nVertLevels"),
                    np_(vert.resting_thickness).astype(f64)[None],
                ),
                "bottomDepth": (
                    ("nCells",),
                    np_(vert.bottom_depth).astype(f64),
                ),
                "vertCoordMovementWeights": (
                    ("nVertLevels",),
                    np_(vert.vert_coord_movement_weights).astype(f64),
                ),
            }
        )

    if initial_state is not None:
        ssh, h, u = initial_state
        variables.update(
            {
                "ssh": (("Time", "nCells"), np.asarray(ssh, dtype=f64)[None]),
                "layerThickness": (
                    ("Time", "nCells", "nVertLevels"),
                    np.asarray(h, dtype=f64)[None],
                ),
                "normalVelocity": (
                    ("Time", "nEdges", "nVertLevels"),
                    np.asarray(u, dtype=f64)[None],
                ),
            }
        )

    if cell_fields:
        k = variables.get("layerThickness")
        n_lv = (
            k[1].shape[2] if k is not None
            else (vert.n_vert_levels if vert is not None else 1)
        )
        for name, field in cell_fields.items():
            a = np.asarray(field, dtype=f64)
            if a.ndim == 1:
                a = np.repeat(a[:, None], n_lv, axis=1)
            variables[name] = (("Time", "nCells", "nVertLevels"), a[None])

    attrs = {
        "on_a_sphere": "YES" if horz.on_sphere else "NO",
        "sphere_radius": float(horz.sphere_radius),
        "is_periodic": "YES" if (horz.lx > 0 and not horz.on_sphere) else "NO",
        "x_period": float(horz.lx),
        "y_period": float(horz.ly),
        "source": "mpas_ocean mesh generator",
    }
    write_netcdf(path, dims, variables, attrs)
