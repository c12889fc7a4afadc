"""Iso-surface extraction from the dense-block TSDF
(port of ``bundlefusion_tpu.fusion.marching_cubes``).

Cells are polygonized by marching tetrahedra (each cube split into 6
tetrahedra sharing the main diagonal): the 16-case tet table is derived in
code, the mesh is crack-free across cells, and the per-cell work is
branch-free masked arithmetic over a batch of blocks. Triangle orientation
is fixed afterwards by aligning each face normal with the tet's linear SDF
gradient. The output is a coloured triangle soup in block-slot order.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..config import AppConfig
from .blocks import BLOCK, INVALID_KEY, NVOX, BlockTable, corner_offsets, lookup, pack_key, unpack_key

# the 6-tetrahedron decomposition of a cube (vertex v has offsets
# ((v>>0)&1, (v>>1)&1, (v>>2)&1) in (x, y, z))
_TETS = np.array(
    [[0, 5, 1, 7], [0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7]], dtype=np.int64
)

# tet edges as pairs of local tet-vertex indices (a=0, b=1, c=2, d=3)
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64)  # ab ac ad bc bd cd


def _build_tet_table() -> np.ndarray:
    """[16, 2, 3] triangle table: per inside-mask case, up to 2 triangles of
    tet-edge indices (-1 padded); orientation is fixed later."""
    ab, ac, ad, bc, bd, cd = range(6)
    t = -np.ones((16, 2, 3), dtype=np.int64)
    # single vertex inside
    t[0b0001, 0] = (ab, ac, ad)  # a
    t[0b0010, 0] = (ab, bd, bc)  # b
    t[0b0100, 0] = (ac, bc, cd)  # c
    t[0b1000, 0] = (ad, cd, bd)  # d
    # two vertices inside (quad -> 2 tris)
    t[0b0011] = [(ac, ad, bd), (ac, bd, bc)]  # a, b
    t[0b0101] = [(ab, ad, cd), (ab, cd, bc)]  # a, c
    t[0b1001] = [(ab, ac, cd), (ab, cd, bd)]  # a, d
    t[0b0110] = [(ab, bd, cd), (ab, cd, ac)]  # b, c
    t[0b1010] = [(ab, bc, cd), (ab, cd, ad)]  # b, d
    t[0b1100] = [(ac, ad, bd), (ac, bd, bc)]  # c, d
    # complements cross the same edges; mirror every unfilled case
    for case in range(1, 15):
        if t[case, 0, 0] == -1:
            t[case] = t[15 ^ case]
    return t


_TET_TABLE = _build_tet_table()


def _corner_sdf_for_blocks(table: BlockTable, slots: torch.Tensor, voxel_size: float):
    """For blocks at ``slots`` [B]: the 9x9x9 voxel-centre SDF / colour /
    observed grids (the extra layer from the +1 neighbours via lookups), and
    the corners' world positions."""
    bc = unpack_key(table.key_of_slot[slots])  # [B, 3]
    g = torch.arange(BLOCK + 1, dtype=torch.int32, device=slots.device)
    zz, yy, xx = torch.meshgrid(g, g, g, indexing="ij")
    local = torch.stack([xx, yy, zz], dim=-1)  # [9, 9, 9, 3]
    vox = bc[:, None, None, None, :] * BLOCK + local[None]
    nb_bc = torch.div(vox, BLOCK, rounding_mode="floor")
    nb_local = vox - nb_bc * BLOCK
    slot, found = lookup(table, pack_key(nb_bc))
    slot = slot.long()
    v = (nb_local[..., 2] * 64 + nb_local[..., 1] * 8 + nb_local[..., 0]).long()
    sdf = table.sdf[slot, v]
    wgt = table.weight[slot, v]
    col = torch.stack([table.color[slot, ch * NVOX + v] for ch in range(3)], dim=-1)
    ok = found & (wgt > 0)
    sdf = torch.where(ok, sdf, torch.inf)
    col = torch.where(ok[..., None], col / torch.clamp(wgt, min=1e-9)[..., None], 0.0)
    pos = (vox.to(torch.float32) + 0.5) * voxel_size
    return sdf, col, ok, pos


def _mesh_blocks(table: BlockTable, slots: torch.Tensor, voxel_size: float):
    """Polygonize a batch of blocks. Returns the fixed-capacity triangle soup
    (verts [B, 8^3*6*2, 3, 3], colours [same], valid [B, 8^3*6*2])."""
    dev = slots.device
    sdf, col, ok, pos = _corner_sdf_for_blocks(table, slots, voxel_size)  # [B, 9, 9, 9, ...]
    offs = corner_offsets("cpu").tolist()

    def corners(arr):  # [B, 9, 9, 9, ...] -> [B, 512, 8(corner), ...]
        parts = [arr[:, dz : dz + BLOCK, dy : dy + BLOCK, dx : dx + BLOCK] for dx, dy, dz in offs]
        st = torch.stack(parts, dim=4)
        return st.reshape((st.shape[0], BLOCK**3) + st.shape[4:])

    c_sdf, c_ok, c_col, c_pos = corners(sdf), corners(ok), corners(col), corners(pos)
    b = c_sdf.shape[0]
    cell_ok = torch.all(c_ok, dim=-1)  # [B, 512]
    tets = torch.as_tensor(_TETS, device=dev)
    tet_edges = torch.as_tensor(_TET_EDGES, device=dev)
    table_t = torch.as_tensor(_TET_TABLE, device=dev)

    s_t = c_sdf[:, :, tets]  # [B, 512, 6, 4]
    p_t = c_pos[:, :, tets]  # [B, 512, 6, 4, 3]
    col_t = c_col[:, :, tets]
    inside = (s_t < 0).to(torch.int64)
    case = inside[..., 0] | (inside[..., 1] << 1) | (inside[..., 2] << 2) | (inside[..., 3] << 3)

    # zero crossings on all 6 tet edges: [B, 512, 6, 6(edge), 3]
    sa, sb = s_t[..., tet_edges[:, 0]], s_t[..., tet_edges[:, 1]]
    pa, pb = p_t[:, :, :, tet_edges[:, 0]], p_t[:, :, :, tet_edges[:, 1]]
    ca, cb = col_t[:, :, :, tet_edges[:, 0]], col_t[:, :, :, tet_edges[:, 1]]
    denom = sa - sb
    big = torch.abs(denom) > 1e-12
    alpha = torch.where(big, sa / torch.where(big, denom, 1.0), 0.5)
    alpha = torch.clamp(alpha, 0.0, 1.0)[..., None]
    e_pos = pa + alpha * (pb - pa)
    e_col = ca + alpha * (cb - ca)

    tri_edges = table_t[case]  # [B, 512, 6, 2, 3] edge ids or -1
    tri_valid = (tri_edges[..., 0] >= 0) & cell_ok[:, :, None, None]  # [B, 512, 6, 2]
    te = torch.clamp(tri_edges, 0, 5)
    b_i = torch.arange(b, device=dev)[:, None, None, None, None]
    c_i = torch.arange(BLOCK**3, device=dev)[None, :, None, None, None]
    t_i = torch.arange(6, device=dev)[None, None, :, None, None]
    tv = e_pos[b_i, c_i, t_i, te]  # [B, 512, 6, 2, 3(vert), 3(xyz)]
    tc = e_col[b_i, c_i, t_i, te]

    # orient: flip triangles whose geometric normal opposes the tet's linear
    # SDF gradient direction g ~ sum_e s_e (p_e - p_mean)
    n_geom = torch.linalg.cross(tv[..., 1, :] - tv[..., 0, :], tv[..., 2, :] - tv[..., 0, :], dim=-1)
    g_dir = torch.einsum("bcte,bctev->bctv", s_t, p_t) - torch.mean(p_t, dim=-2) * torch.sum(s_t, dim=-1)[..., None]
    flip = torch.einsum("bctv,bctrv->bctr", g_dir, n_geom) < 0  # [B, 512, 6, 2]
    tv = torch.where(flip[..., None, None], tv.flip(-2), tv)
    tc = torch.where(flip[..., None, None], tc.flip(-2), tc)
    return tv.reshape(b, -1, 3, 3), torch.clamp(tc.reshape(b, -1, 3, 3), 0.0, 1.0), tri_valid.reshape(b, -1)


def extract_mesh(
    table: BlockTable, cfg: AppConfig, block_batch: int = 256
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Mesh all occupied blocks, ``block_batch`` blocks per device pass.
    Returns (vertices [V, 3], colours [V, 3], faces [F, 3]) as numpy. The
    soup comes out in the JAX package's order (slot order, then cell, tet,
    triangle) whatever the batch, and is cut at ``cfg.mc_max_triangles``
    with the same warning."""
    occupied = torch.any(table.weight[: table.capacity] > 0, dim=1) & (table.key_of_slot != INVALID_KEY)
    slots_all = torch.nonzero(occupied).reshape(-1)
    v_out, c_out = [], []
    for start in range(0, slots_all.shape[0], block_batch):
        verts, cols, valid = _mesh_blocks(table, slots_all[start : start + block_batch], cfg.voxel_size)
        m = valid.reshape(-1)
        v_out.append(verts.reshape(-1, 3, 3)[m].cpu().numpy())
        c_out.append(cols.reshape(-1, 3, 3)[m].cpu().numpy())
    if sum(len(v) for v in v_out) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    tris = np.concatenate(v_out)  # [F, 3, 3]
    cols = np.concatenate(c_out)
    if len(tris) > cfg.mc_max_triangles:
        # triangle-soup capacity (s_marchingCubesMaxNumTriangles analog)
        warnings.warn(
            f"marching cubes: {len(tris)} triangles exceed mc_max_triangles={cfg.mc_max_triangles}; truncating",
            stacklevel=2,
        )
        tris = tris[: cfg.mc_max_triangles]
        cols = cols[: cfg.mc_max_triangles]
    nf = len(tris)
    return tris.reshape(-1, 3), cols.reshape(-1, 3), np.arange(nf * 3, dtype=np.int32).reshape(-1, 3)
