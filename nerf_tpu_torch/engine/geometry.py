"""Geometry extraction from a trained radiance field (port of
``nerf_tpu/engine/geometry.py``).

- The density grid is swept on the model's device: each chunk's sample
  coordinates come from its linear chunk index (``torch.arange`` on the
  device), go through positional encoding and the module as one batched
  evaluation, and land in a device buffer, one chunk after another. Only the
  final (R, R, R) float32 sigma grid crosses to the host. The sweep takes the
  plain field, as the JAX package's does (no kernel, no anneal, no remat).
- The isosurfacer is the JAX package's vectorized marching-tetrahedra pass
  (host-side numpy, this package's own copy): each grid cube splits into 6
  tetrahedra around its 0-6 diagonal (a face-consistent decomposition, so
  meshes are watertight by construction), surface cells are pre-filtered
  with an 8-corner min/max test, and shared-edge vertices weld exactly
  because every crossing is interpolated from the lower global vertex id to
  the higher one and keyed by its global edge id.

Outputs are binary little-endian PLY (vertex colours sampled from the
radiance field at a fixed view direction), byte for byte the JAX package's.
Models are ``nn.Module``s that hold their weights, so the functions here take
a module where the JAX ones take a (model, params) pair.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from .renderer import RenderSettings, encode_points

# ---------------------------------------------------------------------------
# Device-side field sampling
# ---------------------------------------------------------------------------


def _field_settings(settings: RenderSettings) -> RenderSettings:
    """Grid queries always take the exact plain path (no kernel, no anneal)."""
    return dataclasses.replace(settings, use_pallas=False, pe_alpha_xyz=-1.0, remat=False)


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _apply_field(model, pts: torch.Tensor, settings: RenderSettings) -> torch.Tensor:
    """Evaluate the raw field at ``pts`` (C, 3) -> (C, 4) [r, g, b, sigma_raw].

    View-dependent models get a fixed -z view direction: the density head
    never sees it, and for colours a fixed frontal direction is the usual
    vertex-bake convention.
    """
    s = settings
    viewdirs = None
    if getattr(model, "use_viewdirs", True) and model.dim_dir > 0:
        viewdirs = torch.tensor([0.0, 0.0, -1.0], dtype=pts.dtype,
                                device=pts.device).expand(pts.shape)
    enc = encode_points(pts[:, None, :], viewdirs, s)
    if s.compute_dtype != "float32":
        enc = enc.to(getattr(torch, s.compute_dtype))
    return model(enc).float()[:, 0, :]


def sigma_chunk_body(model, settings: RenderSettings, resolution: int,
                     bbox_min: Tuple[float, float, float],
                     bbox_max: Tuple[float, float, float], chunk: int):
    """``one_chunk(c) -> (chunk,) sigma`` for linear chunk index ``c``.

    Makes the chunk's grid coordinates from ``c`` on the model's device,
    encodes them and evaluates the density head. Indices past the grid (the
    tail chunk's padding) give points past the bbox; the caller slices them
    off.
    """
    s = _field_settings(settings)
    r = int(resolution)
    device = _device(model)
    lo = torch.tensor(bbox_min, dtype=torch.float32, device=device)
    hi = torch.tensor(bbox_max, dtype=torch.float32, device=device)
    scale = (hi - lo) / max(r - 1, 1)
    offsets = torch.arange(chunk, device=device)

    def one_chunk(c: int) -> torch.Tensor:
        lin = c * chunk + offsets
        k = lin % r
        j = (lin // r) % r
        i = lin // (r * r)
        ijk = torch.stack([i, j, k], dim=-1).to(torch.float32)
        pts = lo + ijk * scale
        return torch.relu(_apply_field(model, pts, s)[:, 3])

    return one_chunk


def make_sigma_grid_fn(model, settings: RenderSettings, resolution: int,
                       bbox_min: Tuple[float, float, float],
                       bbox_max: Tuple[float, float, float], chunk: int = 65536, mesh=None):
    """Build ``grid_fn() -> (R, R, R) float32 sigma`` (a numpy array).

    Grid axis order is (x, y, z); vertex (i, j, k) sits at
    ``bbox_min + (i, j, k) / (R - 1) * (bbox_max - bbox_min)``. The chunks
    run one after another into one device buffer; nothing crosses to the
    device per call, and only the grid comes back.

    ``mesh`` (``parallel.mesh.Mesh``): the chunks are dealt out in contiguous
    blocks, every rank the same number (the tail's padding past the grid
    computed and sliced off), and rank 0 gathers the grid; the other ranks
    get None. The chunk boundaries and the body are the serial sweep's, so
    the grid is bitwise the serial one's on the same device.
    """
    r = int(resolution)
    n = r ** 3
    chunk = int(min(chunk, n))
    num_chunks = (n + chunk - 1) // chunk
    world, rank = (1, 0) if mesh is None else (mesh.world_size, mesh.rank)
    local = -(-num_chunks // world)
    one_chunk = sigma_chunk_body(model, settings, r, bbox_min, bbox_max, chunk)

    def grid_fn() -> Optional[np.ndarray]:
        with torch.inference_mode():
            sig = torch.empty(local * chunk, dtype=torch.float32, device=_device(model))
            for i in range(local):
                sig[i * chunk:(i + 1) * chunk] = one_chunk(rank * local + i)
            if mesh is not None:
                sig = mesh.gather_rows(sig)
                if sig is None:
                    return None
            return sig[:n].reshape(r, r, r).cpu().numpy()

    return grid_fn


def density_aabb(model, settings: RenderSettings, resolution: int = 64,
                 bbox_min: Tuple[float, float, float] = (-1.5, -1.5, -1.5),
                 bbox_max: Tuple[float, float, float] = (1.5, 1.5, 1.5),
                 tau: float = 1.0, chunk: int = 65536
                 ) -> Tuple[float, float, float, float, float, float]:
    """Axis-aligned bounding box of the field's occupied region.

    Sweeps a ``resolution``^3 sigma grid over ``[bbox_min, bbox_max]`` and
    returns the tight (xmin, ymin, zmin, xmax, ymax, zmax) around vertices
    with post-ReLU sigma > ``tau``, padded by one voxel so surfaces that
    straddle the threshold stay inside. Feed the result to
    ``RenderSettings.aabb`` to tighten every ray's sample interval to its
    crossing of the box. Falls back to the sweep bounds when nothing exceeds
    ``tau`` (an untrained field).

    Warns (``UserWarning``) when the occupied region touches the sweep cube
    on any face: geometry past the sweep bounds would be clipped, and rays
    tightened onto that box would cut real geometry; re-run with wider
    bounds (the CLIs' ``--aabb-sweep-bounds``).
    """
    sigma = make_sigma_grid_fn(model, settings, resolution, bbox_min, bbox_max, chunk)()
    occupied = np.argwhere(sigma > tau)
    lo = np.asarray(bbox_min, np.float64)
    hi = np.asarray(bbox_max, np.float64)
    if occupied.size == 0:
        return tuple(lo) + tuple(hi)
    occ_lo = occupied.min(axis=0)
    occ_hi = occupied.max(axis=0)
    if np.any(occ_lo == 0) or np.any(occ_hi == resolution - 1):
        faces = [
            f"{'xyz'[a]}{'-+'[side]}"
            for a in range(3)
            for side, touch in ((0, occ_lo[a] == 0), (1, occ_hi[a] == resolution - 1))
            if touch
        ]
        lo_s = ", ".join(f"{v:g}" for v in lo)
        hi_s = ", ".join(f"{v:g}" for v in hi)
        warnings.warn(
            f"density_aabb: occupied region (sigma > {tau}) touches the "
            f"sweep bounds on face(s) {', '.join(faces)} — geometry may "
            f"extend past [({lo_s}), ({hi_s})] and would be clipped; "
            "widen the sweep bounds (--aabb-sweep-bounds).",
            stacklevel=2,
        )
    scale = (hi - lo) / (resolution - 1)
    box_lo = np.maximum(lo + (occ_lo - 1) * scale, lo)
    box_hi = np.minimum(lo + (occ_hi + 1) * scale, hi)
    return tuple(float(v) for v in box_lo) + tuple(float(v) for v in box_hi)


def tighten_to_density_aabb(model, settings, tau: float, sweep_bounds=None):
    """``density_aabb`` of ``model`` at ``settings`` over ``sweep_bounds``
    (x0, y0, z0, x1, y1, z1; default the blender cube), printed with its
    seconds as the JAX CLIs print it; returns ``(box, seconds)``."""
    t0 = time.time()
    sweep_kw = {}
    if sweep_bounds is not None:
        sweep_kw = dict(bbox_min=tuple(sweep_bounds[:3]), bbox_max=tuple(sweep_bounds[3:]))
    box = density_aabb(model, settings, tau=tau, **sweep_kw)
    seconds = time.time() - t0
    print(f"density AABB (tau={tau}): "
          f"[{box[0]:.2f},{box[1]:.2f},{box[2]:.2f}] - "
          f"[{box[3]:.2f},{box[4]:.2f},{box[5]:.2f}] "
          f"({seconds:.1f}s)", flush=True)
    return box, seconds


def _make_chunked_point_query(model, per_chunk_fn, chunk: int):
    """Host wrapper shared by the vertex queries: pad the host points to a
    chunk multiple (repeating the last point), run ``per_chunk_fn`` on each
    chunk on the model's device, slice the padding back off.

    The chunk shrinks to the point count rounded up to 1024, so a small
    vertex bake never pads up to a grid-sweep-sized batch.
    """

    def query_fn(pts: np.ndarray) -> np.ndarray:
        pts = np.asarray(pts, dtype=np.float32)
        n = pts.shape[0]
        if n == 0:
            return np.zeros((0, 3), dtype=np.float32)
        eff = min(chunk, (n + 1023) // 1024 * 1024)
        padded = (n + eff - 1) // eff * eff
        if padded != n:
            pts = np.concatenate([pts, np.broadcast_to(pts[-1:], (padded - n, 3))], axis=0)
        dev = torch.as_tensor(pts, device=_device(model))
        out = torch.cat([per_chunk_fn(dev[i:i + eff]) for i in range(0, padded, eff)])
        return out.cpu().numpy()[:n]

    return query_fn


def make_rgb_query_fn(model, settings: RenderSettings, chunk: int = 65536):
    """Build ``rgb_fn(pts (N, 3)) -> (N, 3) float32 in [0, 1]``."""
    s = _field_settings(settings)

    def one(p):
        with torch.inference_mode():
            return torch.sigmoid(_apply_field(model, p, s)[:, :3])

    return _make_chunked_point_query(model, one, chunk)


def make_normals_query_fn(model, settings: RenderSettings, chunk: int = 65536):
    """Build ``normals_fn(pts (N, 3)) -> (N, 3) float32 unit normals``.

    Surface normal = the negated, normalized gradient of the pre-ReLU
    density (it increases toward the interior), by autograd through the
    encode + MLP: the gradient of the chunk's summed sigma with respect to
    its points, which is each point's own gradient because the points are
    evaluated independently. Zero-gradient points get a zero normal.
    """
    s = _field_settings(settings)

    def one(p):
        with torch.enable_grad():
            p = p.detach().requires_grad_(True)
            # Pre-ReLU alpha: equal to sigma wherever a surface exists
            # (sigma > 0) and smooth across it.
            (g,) = torch.autograd.grad(_apply_field(model, p, s)[:, 3].sum(), p)
        return -g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-12)

    return _make_chunked_point_query(model, one, chunk)


# ---------------------------------------------------------------------------
# Marching tetrahedra (host-side numpy)
# ---------------------------------------------------------------------------

# Cube corner numbering (dx, dy, dz); 6-tet split around the 0-6 diagonal.
_CUBE_OFFSETS = np.array(
    [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
     (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)],
    dtype=np.int64,
)
# (0, a, b, 6) with (a, b) walking the equator cycle 1-2-3-7-4-5-1: every
# tet is positively oriented and every cube face is cut by the SAME
# diagonal as its neighbour's matching face (translates of the 0-6
# direction), the property that makes the global mesh watertight.
_TET_CORNERS = np.array(
    [(0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6),
     (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6)],
    dtype=np.int64,
)
# Tet edge numbering used by the case table.
_TET_EDGES = np.array([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)], dtype=np.int64)
# case = sum(2^i for tet-vertex i with value > iso) -> triangles as edge-id
# triples, wound so normals point OUT of the high-value region (for a
# positively oriented tet).
_TRI_TABLE = {
    1: [(0, 1, 2)],
    2: [(0, 4, 3)],
    3: [(1, 2, 4), (1, 4, 3)],
    4: [(1, 3, 5)],
    5: [(0, 3, 5), (0, 5, 2)],
    6: [(0, 4, 5), (0, 5, 1)],
    7: [(2, 4, 5)],
    8: [(2, 5, 4)],
    9: [(0, 1, 5), (0, 5, 4)],
    10: [(0, 2, 5), (0, 5, 3)],
    11: [(1, 5, 3)],
    12: [(1, 3, 4), (1, 4, 2)],
    13: [(0, 3, 4)],
    14: [(0, 2, 1)],
}


def _active_cells(values: np.ndarray, iso: float) -> np.ndarray:
    """(A, 3) integer base indices of the cells straddling ``iso``."""
    inside = values > iso
    occ = inside[:-1, :-1, :-1].astype(np.uint8)
    for dx, dy, dz in _CUBE_OFFSETS[1:]:
        occ = occ + inside[
            dx: dx + inside.shape[0] - 1,
            dy: dy + inside.shape[1] - 1,
            dz: dz + inside.shape[2] - 1,
        ]
    return np.argwhere((occ > 0) & (occ < 8))


def marching_tetrahedra(values: np.ndarray, iso: float,
                        origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                        spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the ``values > iso`` isosurface of a 3-D scalar grid.

    Returns ``(vertices (V, 3) float32, faces (F, 3) int64)`` with faces
    wound counter-clockwise seen from outside (the low-value side).
    Vertices on edges shared between tetrahedra and cells are welded exactly
    (the same canonical interpolation and global edge key), so closed
    surfaces come out watertight and consistently oriented.
    """
    values = np.asarray(values, dtype=np.float64)
    if values.ndim != 3 or min(values.shape) < 2:
        raise ValueError(f"need a 3-D grid with every dim >= 2, got {values.shape}")
    nx, ny, nz = values.shape
    origin = np.asarray(origin, dtype=np.float64)
    spacing = np.asarray(spacing, dtype=np.float64)

    cells = _active_cells(values, iso)
    tri_keys, tri_t, tri_ga = [], [], []
    if cells.shape[0]:
        flat = values.reshape(-1)
        # (A, 8) global vertex ids of each active cell's corners.
        corner = (
            (cells[:, 0:1] + _CUBE_OFFSETS[:, 0]) * (ny * nz)
            + (cells[:, 1:2] + _CUBE_OFFSETS[:, 1]) * nz
            + (cells[:, 2:3] + _CUBE_OFFSETS[:, 2])
        )
        for tet in _TET_CORNERS:
            tv = corner[:, tet]                       # (A, 4) global ids
            vals = flat[tv]                           # (A, 4)
            case = ((vals > iso).astype(np.int64) << np.arange(4)).sum(axis=1)
            for c, tris in _TRI_TABLE.items():
                sel = np.nonzero(case == c)[0]
                if not sel.size:
                    continue
                for tri in tris:
                    ek = _TET_EDGES[list(tri)]        # (3, 2) local corners
                    ga, gb = tv[sel][:, ek[:, 0]], tv[sel][:, ek[:, 1]]
                    va, vb = vals[sel][:, ek[:, 0]], vals[sel][:, ek[:, 1]]
                    # Canonical direction: low global id -> high, so the
                    # same edge interpolates bit-identically in every tet.
                    swap = ga > gb
                    ga2 = np.where(swap, gb, ga)
                    gb2 = np.where(swap, ga, gb)
                    va2 = np.where(swap, vb, va)
                    vb2 = np.where(swap, va, vb)
                    t = (iso - va2) / (vb2 - va2)
                    # A crossing exactly on a grid corner (t exactly 0 or 1)
                    # is keyed by the CORNER id, so every edge incident to
                    # that corner welds to one vertex.
                    n_vert = nx * ny * nz
                    key = np.where(
                        t == 0.0, ga2,
                        np.where(t == 1.0, gb2, n_vert + ga2 * n_vert + gb2),
                    )
                    tri_keys.append(key)
                    tri_t.append(t)
                    tri_ga.append(np.stack([ga2, gb2], axis=-1))
    if not tri_keys:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    keys = np.concatenate(tri_keys, axis=0)           # (F, 3)
    ts = np.concatenate(tri_t, axis=0)                # (F, 3)
    gab = np.concatenate(tri_ga, axis=0)              # (F, 3, 2)

    _, first, inv = np.unique(keys.reshape(-1), return_index=True, return_inverse=True)
    faces = inv.reshape(-1, 3)
    ga = gab.reshape(-1, 2)[first]                    # (V, 2) endpoint ids
    tv = ts.reshape(-1)[first]                        # (V,)

    def unflatten(g):
        return np.stack([g // (ny * nz), (g // nz) % ny, g % nz], axis=-1)

    pa = origin + unflatten(ga[:, 0]) * spacing
    pb = origin + unflatten(ga[:, 1]) * spacing
    tcol = tv[:, None]
    # Exact corner positions at t == 0/1; plain interpolation elsewhere.
    verts = np.where(
        tcol == 0.0, pa, np.where(tcol == 1.0, pb, pa + tcol * (pb - pa))
    ).astype(np.float32)
    # Corner-welded vertices collapse some triangles to zero area; drop them.
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts, faces[ok]


# ---------------------------------------------------------------------------
# High-level extraction
# ---------------------------------------------------------------------------


def _grid(model, settings, resolution, bbox_min, bbox_max, chunk, sigma_grid):
    if sigma_grid is None:
        sigma_grid = make_sigma_grid_fn(model, settings, resolution, bbox_min, bbox_max, chunk)()
    lo = np.asarray(bbox_min, dtype=np.float64)
    hi = np.asarray(bbox_max, dtype=np.float64)
    return sigma_grid, lo, (hi - lo) / max(sigma_grid.shape[0] - 1, 1)


def _colors(model, settings, chunk, pts) -> np.ndarray:
    rgb = make_rgb_query_fn(model, settings, chunk)(pts)
    return np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)


def extract_mesh(model, settings: RenderSettings,
                 bbox_min: Tuple[float, float, float] = (-1.5, -1.5, -1.5),
                 bbox_max: Tuple[float, float, float] = (1.5, 1.5, 1.5),
                 resolution: int = 256, iso: float = 50.0, chunk: int = 65536,
                 with_colors: bool = True, with_normals: bool = True,
                 sigma_grid: Optional[np.ndarray] = None,
                 ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """Density grid -> marching-tets mesh (+ baked vertex colours/normals).

    ``iso=50`` is the original NeRF release's extract_mesh convention.
    Normals come from the autograd density gradient
    (:func:`make_normals_query_fn`), not from face geometry.
    Returns ``(vertices, faces, colors_uint8 | None, normals | None)``.
    """
    sigma_grid, lo, spacing = _grid(model, settings, resolution, bbox_min, bbox_max, chunk,
                                    sigma_grid)
    verts, faces = marching_tetrahedra(sigma_grid, iso, origin=lo, spacing=spacing)
    colors = normals = None
    if with_colors and verts.shape[0]:
        colors = _colors(model, settings, chunk, verts)
    if with_normals and verts.shape[0]:
        normals = make_normals_query_fn(model, settings, chunk)(verts)
    return verts, faces, colors, normals


def extract_pointcloud(model, settings: RenderSettings,
                       bbox_min: Tuple[float, float, float] = (-1.5, -1.5, -1.5),
                       bbox_max: Tuple[float, float, float] = (1.5, 1.5, 1.5),
                       resolution: int = 256, threshold: float = 50.0, chunk: int = 65536,
                       max_points: int = 0, seed: int = 0,
                       sigma_grid: Optional[np.ndarray] = None,
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Grid vertices with ``sigma > threshold`` as a coloured point cloud.

    Returns ``(points (N, 3) float32, colors (N, 3) uint8, sigmas (N,))``;
    ``max_points > 0`` subsamples uniformly at random (``seed``).
    """
    sigma_grid, lo, spacing = _grid(model, settings, resolution, bbox_min, bbox_max, chunk,
                                    sigma_grid)
    idx = np.argwhere(sigma_grid > threshold)
    sigmas = sigma_grid[sigma_grid > threshold]
    if max_points and idx.shape[0] > max_points:
        keep = np.random.default_rng(seed).choice(idx.shape[0], size=max_points, replace=False)
        idx, sigmas = idx[keep], sigmas[keep]
    pts = (lo + idx * spacing).astype(np.float32)
    colors = (_colors(model, settings, chunk, pts) if pts.shape[0]
              else np.zeros((0, 3), dtype=np.uint8))
    return pts, colors, np.asarray(sigmas, dtype=np.float32)


# ---------------------------------------------------------------------------
# PLY I/O
# ---------------------------------------------------------------------------

_FACE_DTYPE = np.dtype([("n", "u1"), ("i0", "<i4"), ("i1", "<i4"), ("i2", "<i4")])


def _vertex_fields(normals: bool, colors: bool):
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if normals:
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    if colors:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    return fields


def save_ply(path: str, vertices: np.ndarray, faces: Optional[np.ndarray] = None,
             colors: Optional[np.ndarray] = None, normals: Optional[np.ndarray] = None) -> None:
    """Write a binary little-endian PLY (optional faces/normals/uchar colours)."""
    vertices = np.asarray(vertices, dtype=np.float32)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {vertices.shape[0]}",
              "property float x", "property float y", "property float z"]
    if normals is not None:
        header += ["property float nx", "property float ny", "property float nz"]
    if colors is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    if faces is not None:
        header += [f"element face {faces.shape[0]}", "property list uchar int vertex_indices"]
    header.append("end_header")

    vdata = np.empty(vertices.shape[0], dtype=_vertex_fields(normals is not None,
                                                             colors is not None))
    vdata["x"], vdata["y"], vdata["z"] = vertices.T
    if normals is not None:
        vdata["nx"], vdata["ny"], vdata["nz"] = np.asarray(normals, dtype=np.float32).T
    if colors is not None:
        vdata["red"], vdata["green"], vdata["blue"] = np.asarray(colors, dtype=np.uint8).T
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(vdata.tobytes())
        if faces is not None:
            fdata = np.empty(faces.shape[0], dtype=_FACE_DTYPE)
            fdata["n"] = 3
            fdata["i0"], fdata["i1"], fdata["i2"] = np.asarray(faces, np.int32).T
            f.write(fdata.tobytes())


def load_ply(path: str):
    """Read PLYs written by :func:`save_ply`.

    Returns ``(vertices, faces | None, colors | None, normals | None)``.
    """
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    nv = nf = 0
    has_color = has_normals = False
    for ln in data[:end].decode("ascii").splitlines():
        if ln.startswith("element vertex"):
            nv = int(ln.split()[-1])
        elif ln.startswith("element face"):
            nf = int(ln.split()[-1])
        elif ln == "property uchar red":
            has_color = True
        elif ln == "property float nx":
            has_normals = True
    vdt = np.dtype(_vertex_fields(has_normals, has_color))
    vdata = np.frombuffer(data, dtype=vdt, count=nv, offset=end)
    verts = np.stack([vdata["x"], vdata["y"], vdata["z"]], axis=-1)
    colors = (np.stack([vdata["red"], vdata["green"], vdata["blue"]], axis=-1)
              if has_color else None)
    normals = (np.stack([vdata["nx"], vdata["ny"], vdata["nz"]], axis=-1)
               if has_normals else None)
    faces = None
    if nf:
        fdata = np.frombuffer(data, dtype=_FACE_DTYPE, count=nf, offset=end + nv * vdt.itemsize)
        faces = np.stack([fdata["i0"], fdata["i1"], fdata["i2"]], axis=-1).astype(np.int64)
    return verts, faces, colors, normals
