"""3D linear elasticity on Q1 hexahedra (a cube of n^3 nodes, unit
spacing, the x = 0 face clamped): the 24 x 24 element stiffness from E and
nu, the operator assembled as 3 x 3 blocks a node and neighbour, the six
rigid-body modes, and the fp64 residual b - K x computed element by
element, without the assembled matrix.

Dofs are the free nodes' in lexicographic order (x slowest, z fastest),
three a node; the clamped nodes' displacements are zero.  NumPy, SciPy and
torch only: nothing of the program, and no JAX.
"""

from __future__ import annotations

import itertools

import numpy as np
import scipy.sparse as sp
import torch

# the element's corners, x fastest: local node a = sx + 2 sy + 4 sz
CORNERS = [(sx, sy, sz) for sz in (0, 1) for sy in (0, 1) for sx in (0, 1)]
# node-neighbour offsets in lexicographic order (x slowest): increasing
# neighbour ids, so each row's columns come out sorted
OFFSETS = list(itertools.product((-1, 0, 1), repeat=3))


def hex_stiffness(E: float, nu: float) -> np.ndarray:
    """(24, 24) Q1 stiffness of a unit cube, 2 x 2 x 2 Gauss quadrature,
    isotropic material (Voigt order xx, yy, zz, yz, xz, xy); dof 3a + d is
    corner a's displacement along d."""
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    C = np.zeros((6, 6))
    C[:3, :3] = lam
    C[np.arange(3), np.arange(3)] += 2 * mu
    C[3:, 3:] = np.eye(3) * mu
    g = 1.0 / np.sqrt(3.0)
    signs = [(2 * sx - 1, 2 * sy - 1, 2 * sz - 1) for sx, sy, sz in CORNERS]
    K = np.zeros((24, 24))
    for xi, eta, zeta in [(sx * g, sy * g, sz * g) for sx, sy, sz in signs]:
        Bm = np.zeros((6, 24))
        for a, (sx, sy, sz) in enumerate(signs):
            # dN_a/dx on the unit cube (the reference cube's 2 / h)
            gx = sx * (1 + sy * eta) * (1 + sz * zeta) / 4.0
            gy = sy * (1 + sx * xi) * (1 + sz * zeta) / 4.0
            gz = sz * (1 + sx * xi) * (1 + sy * eta) / 4.0
            c = 3 * a
            Bm[0, c], Bm[1, c + 1], Bm[2, c + 2] = gx, gy, gz
            Bm[3, c + 1], Bm[3, c + 2] = gz, gy
            Bm[4, c], Bm[4, c + 2] = gz, gx
            Bm[5, c], Bm[5, c + 1] = gy, gx
        K += 0.125 * Bm.T @ C @ Bm
    return K


def n_dof(n: int) -> int:
    return 3 * (n - 1) * n * n


def _local(s) -> int:
    return s[0] + 2 * s[1] + 4 * s[2]


# the small grid whose rows give every kind of node its blocks
_M = 5


def _class_blocks(Ke: np.ndarray) -> np.ndarray:
    """(3, 3, 3, 27, 3, 3): a node's 3 x 3 block with each neighbour
    offset, by the node's place along x (next to the clamped face, inside,
    on the far face) and along y and z (low face, inside, high face).

    The blocks are read off a clamped 5^3 grid assembled element by
    element as a COO matrix whose duplicates SciPy sums, so each entry is
    the same sum in the same order as in any other grid assembled so: the
    order of a row's duplicates follows the row's pattern alone, and every
    node of one kind has the same pattern."""
    m = _M
    node = np.arange(m ** 3).reshape(m, m, m)
    free_ids = np.where(node >= m * m, node - m * m, -1).ravel()
    ex, ey, ez = (a.ravel() for a in np.meshgrid(
        np.arange(m - 1), np.arange(m - 1), np.arange(m - 1), indexing="ij"))
    conn = np.stack([node[ex + sx, ey + sy, ez + sz] for sx, sy, sz in CORNERS],
                    axis=1)
    fconn = free_ids[conn]
    dof = (fconn[:, :, None] * 3 + np.arange(3)).reshape(-1, 24)
    dof = np.where(fconn.repeat(3, axis=1) >= 0, dof, -1)
    rows = np.repeat(dof[:, :, None], 24, axis=2).ravel()
    cols = np.repeat(dof[:, None, :], 24, axis=1).ravel()
    vals = np.tile(Ke.ravel(), dof.shape[0])
    keep = (rows >= 0) & (cols >= 0)
    N = 3 * (m - 1) * m * m
    A = sp.coo_matrix((vals[keep], (rows[keep], cols[keep])),
                      shape=(N, N)).tocsr()
    A.sum_duplicates()
    out = np.zeros((3, 3, 3, 27, 3, 3))
    at = {0: (1, 0), 1: (2, 2), 2: (m - 1, m - 1)}  # kind -> (x, y or z)
    for kx, ky, kz in itertools.product(range(3), repeat=3):
        i, j, k = at[kx][0], at[ky][1], at[kz][1]
        p = node[i, j, k] - m * m
        for oi, (di, dj, dk) in enumerate(OFFSETS):
            q = (i + di, j + dj, k + dk)
            if all(0 <= v < m for v in q) and q[0] >= 1:
                c = 3 * (node[q] - m * m)
                out[kx, ky, kz, oi] = A[3 * p:3 * p + 3, c:c + 3].toarray()
    return out


def assemble(n: int, E: float, nu: float, chunk: int = 1 << 18):
    """(K as a SciPy CSR in fp64, B (n_dof, 6) rigid-body modes), n >= 3.

    A node's block with a neighbour is the sum, over the elements that
    hold both, of the element's 3 x 3 block; it depends only on where the
    node lies (``_class_blocks``), so each node takes its kind's blocks,
    a chunk of nodes at a time.  Rows keep every in-grid free neighbour's
    whole block."""
    if n < 3:
        raise ValueError(f"n = {n}: the grid needs at least 3 nodes a side")
    table = _class_blocks(hex_stiffness(E, nu))
    nf = (n - 1) * n * n  # free nodes: x index 1 .. n-1
    off = np.array(OFFSETS)
    lin = off[:, 0] * n * n + off[:, 1] * n + off[:, 2]
    counts = np.empty(nf, dtype=np.int64)
    cols_parts, vals_parts = [], []
    for lo in range(0, nf, chunk):
        p = np.arange(lo, min(lo + chunk, nf))
        ijk = np.stack([p // (n * n) + 1, (p // n) % n, p % n], 1)
        kind = np.where(ijk == n - 1, 2, np.where(ijk == 0, 0, 1))
        kind[:, 0] = np.where(ijk[:, 0] == 1, 0, kind[:, 0])
        blocks = table[kind[:, 0], kind[:, 1], kind[:, 2]]  # (m, 27, 3, 3)
        q = ijk[:, None, :] + off[None, :, :]
        ok = ((q >= 0) & (q < n)).all(2) & (q[:, :, 0] >= 1)  # (m, 27)
        qdof = 3 * (p[:, None] + lin[None, :])  # the neighbours' free ids
        cols = np.broadcast_to(qdof[:, None, :, None] + np.arange(3),
                               (p.size, 3, 27, 3))
        keep = np.broadcast_to(ok[:, None, :, None], cols.shape)
        cols_parts.append(cols[keep])
        # (m, r, o, c): row r of the node's block with neighbour o
        vals_parts.append(blocks.transpose(0, 2, 1, 3)[keep])
        counts[lo:lo + p.size] = 3 * ok.sum(1)
    indptr = np.concatenate([[0], np.cumsum(np.repeat(counts, 3))])
    idx_dt = np.int32 if indptr[-1] < 2**31 else np.int64
    N = 3 * nf
    K = sp.csr_matrix((np.concatenate(vals_parts),
                       np.concatenate(cols_parts).astype(idx_dt),
                       indptr.astype(idx_dt)), shape=(N, N))
    K.has_sorted_indices = True
    return K, rigid_body_modes(n)


def rigid_body_modes(n: int) -> np.ndarray:
    """(n_dof, 6): three translations and the rotations about z, x and y
    of the free nodes' coordinates about their mean."""
    xs, ys, zs = np.meshgrid(np.arange(n), np.arange(n), np.arange(n),
                             indexing="ij")
    free = xs >= 1
    coords = np.stack([xs[free], ys[free], zs[free]], axis=1).astype(np.float64)
    c0 = coords - coords.mean(axis=0)
    B = np.zeros((3 * coords.shape[0], 6))
    for d in range(3):
        B[d::3, d] = 1.0
    B[0::3, 3], B[1::3, 3] = -c0[:, 1], c0[:, 0]
    B[1::3, 4], B[2::3, 4] = -c0[:, 2], c0[:, 1]
    B[0::3, 5], B[2::3, 5] = c0[:, 2], -c0[:, 0]
    return B


def residual(x64: torch.Tensor, b64: torch.Tensor, n: int, E: float,
             nu: float, chunk: int = 1 << 20) -> torch.Tensor:
    """b - K x in fp64 on x's device, element by element: each element
    gathers its 24 displacements (zero at clamped nodes), multiplies them
    by the stiffness and adds the products into the residual
    (``index_add_``), a chunk of elements at a time."""
    dev = x64.device
    nn = n * n * n
    u = torch.zeros(3 * nn, dtype=torch.float64, device=dev)
    u[3 * n * n:] = x64  # the free nodes are the last (n-1) n^2
    Ke = torch.tensor(hex_stiffness(E, nu), dtype=torch.float64, device=dev)
    y = torch.zeros_like(u)
    ne = (n - 1) ** 3
    corner = torch.tensor([sx * n * n + sy * n + sz for sx, sy, sz in CORNERS],
                          device=dev)
    d3 = torch.arange(3, device=dev)
    for lo in range(0, ne, chunk):
        e = torch.arange(lo, min(lo + chunk, ne), device=dev)
        ex, ey, ez = e // ((n - 1) ** 2), (e // (n - 1)) % (n - 1), e % (n - 1)
        base = ex * n * n + ey * n + ez
        dofs = (3 * (base[:, None] + corner[None, :]))[:, :, None] + d3
        dofs = dofs.reshape(-1, 24)
        f = u[dofs] @ Ke.T
        y.index_add_(0, dofs.reshape(-1), f.reshape(-1))
    return b64 - y[3 * n * n:]


def relres(x64: torch.Tensor, b64: torch.Tensor, n: int, E: float,
           nu: float) -> float:
    """||b - K x|| / ||b|| in fp64."""
    r = residual(x64, b64, n, E, nu)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))
