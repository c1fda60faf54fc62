"""Problem gallery: generators for the acceptance configurations.

Capability target (SURVEY.md §0 — the public RAPtor AMG
library named by BASELINE.json:5, not the mounted reference; convergence
spec = tests/oracle/amg_oracle.py): the reference AMG stack's ``gallery/`` (RAPtor's
diffusion/laplacian27pt/par_stencil generators; SURVEY.md §2b C18).  The five
acceptance configs (BASELINE.json:7-11) need: 2D 5-pt Poisson, 3D 7-pt Poisson,
2D rotated anisotropic 9-pt diffusion, 3D 27-pt linear elasticity with 3x3
blocks, and 3D Poisson at scale.

All generators are host-side (NumPy/SciPy) — problem construction is not on
the solve path.  They return ``scipy.sparse.csr_matrix`` (plus near-nullspace
candidates where relevant), which ``raptor_tpu.core`` converts to device ELL.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = [
    "stencil_grid",
    "poisson_2d",
    "poisson_3d",
    "laplacian_27pt",
    "anisotropic_2d",
    "diffusion_stencil_2d",
    "elasticity_3d",
    "convection_diffusion_2d",
    "default_rhs",
]


def stencil_grid(stencil: np.ndarray, grid: tuple[int, ...]) -> sp.csr_matrix:
    """Sparse matrix from a constant stencil on a regular grid.

    Dirichlet-style truncation at the boundary (off-grid connections dropped),
    matching the standard AMG test-problem construction.  ``stencil`` has odd
    extent in every dimension; ``grid`` is the node count per dimension.
    """
    stencil = np.asarray(stencil, dtype=np.float64)
    grid = tuple(int(g) for g in grid)
    ndim = stencil.ndim
    assert len(grid) == ndim and all(s % 2 == 1 for s in stencil.shape)
    n = int(np.prod(grid))

    idx = np.arange(n).reshape(grid)
    coords = np.unravel_index(np.arange(n), grid)

    rows, cols, vals = [], [], []
    centers = [s // 2 for s in stencil.shape]
    for offset in np.ndindex(*stencil.shape):
        v = stencil[offset]
        if v == 0.0:
            continue
        d = [o - c for o, c in zip(offset, centers)]
        mask = np.ones(n, dtype=bool)
        shifted = []
        for axis in range(ndim):
            c = coords[axis] + d[axis]
            mask &= (c >= 0) & (c < grid[axis])
            shifted.append(c)
        r = np.nonzero(mask)[0]
        c = np.ravel_multi_index([s[mask] for s in shifted], grid)
        rows.append(r)
        cols.append(c)
        vals.append(np.full(r.shape[0], v))
    A = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    )
    return A.tocsr()


def poisson_2d(nx: int, ny: int | None = None) -> sp.csr_matrix:
    """2D 5-point Poisson (BASELINE.json:7, config 1)."""
    ny = ny or nx
    st = np.array([[0, -1, 0], [-1, 4, -1], [0, -1, 0]], dtype=np.float64)
    return stencil_grid(st, (nx, ny))


def poisson_3d(nx: int, ny: int | None = None, nz: int | None = None) -> sp.csr_matrix:
    """3D 7-point Poisson (BASELINE.json:8,11 — configs 2 and 5)."""
    ny, nz = ny or nx, nz or nx
    st = np.zeros((3, 3, 3))
    st[1, 1, 1] = 6.0
    for d in range(3):
        i = [1, 1, 1]
        for s in (0, 2):
            i[d] = s
            st[tuple(i)] = -1.0
        i[d] = 1
    return stencil_grid(st, (nx, ny, nz))


def laplacian_27pt(nx: int, ny: int | None = None, nz: int | None = None) -> sp.csr_matrix:
    """3D 27-point Laplacian (trilinear FE discretization of -∆)."""
    ny, nz = ny or nx, nz or nx
    return stencil_grid(_fe_laplacian_stencil_3d(), (nx, ny, nz))


def _q1_gradients_2d(h: float = 1.0):
    """Shape-function gradients of the 4-node bilinear quad at 2x2 Gauss pts."""
    g = 1.0 / np.sqrt(3.0)
    pts = [(-g, -g), (g, -g), (g, g), (-g, g)]
    # Nodes in (x,y) order: (0,0),(1,0),(1,1),(0,1) on [-1,1]^2 ref element.
    signs = [(-1, -1), (1, -1), (1, 1), (-1, 1)]
    grads = np.zeros((4, 4, 2))  # (quad_pt, node, dim)
    for q, (xi, eta) in enumerate(pts):
        for a, (sx, sy) in enumerate(signs):
            grads[q, a, 0] = sx * (1 + sy * eta) / 4.0 * (2.0 / h)
            grads[q, a, 1] = sy * (1 + sx * xi) / 4.0 * (2.0 / h)
    w = np.full(4, (h / 2.0) ** 2)
    return grads, w


def diffusion_stencil_2d(epsilon: float = 1e-3, theta: float = np.pi / 4) -> np.ndarray:
    """9-point bilinear-FE stencil for rotated anisotropic diffusion.

    Operator: -div(Q^T diag(1, eps) Q grad u) with rotation angle theta
    (BASELINE.json:9, config 3).  Derived by assembling the 4 elements around
    a node with 2x2 Gauss quadrature — no hand-copied closed form.
    """
    c, s = np.cos(theta), np.sin(theta)
    Q = np.array([[c, s], [-s, c]])
    D = Q.T @ np.diag([1.0, epsilon]) @ Q

    grads, w = _q1_gradients_2d(1.0)
    Ke = np.einsum("q,qad,de,qbe->ab", w, grads, D, grads)

    # Assemble on a 3x3 node patch (2x2 elements), read the center node row.
    patch = np.zeros((9, 9))
    node = lambda i, j: 3 * j + i  # (x=i, y=j)
    for ex in range(2):
        for ey in range(2):
            loc = [node(ex, ey), node(ex + 1, ey), node(ex + 1, ey + 1), node(ex, ey + 1)]
            for a in range(4):
                for b in range(4):
                    patch[loc[a], loc[b]] += Ke[a, b]
    center = node(1, 1)
    st = np.zeros((3, 3))
    for i in range(3):
        for j in range(3):
            st[i, j] = patch[center, node(i, j)]
    return st


def anisotropic_2d(
    nx: int, ny: int | None = None, epsilon: float = 1e-3, theta: float = np.pi / 4
) -> sp.csr_matrix:
    """2D rotated anisotropic diffusion, 9-point (BASELINE.json:9)."""
    ny = ny or nx
    return stencil_grid(diffusion_stencil_2d(epsilon, theta), (nx, ny))


def _fe_laplacian_stencil_3d() -> np.ndarray:
    """27-pt trilinear-FE Laplacian stencil via patch assembly."""
    grads, w = _q1_gradients_3d(1.0)
    Ke = np.einsum("q,qad,qbd->ab", w, grads, grads)
    return _patch_stencil_3d(Ke)


def _q1_gradients_3d(h: float = 1.0):
    g = 1.0 / np.sqrt(3.0)
    pts = [(sx * g, sy * g, sz * g) for sz in (-1, 1) for sy in (-1, 1) for sx in (-1, 1)]
    signs = _hex_node_signs()
    grads = np.zeros((8, 8, 3))
    for q, (xi, eta, zeta) in enumerate(pts):
        for a, (sx, sy, sz) in enumerate(signs):
            grads[q, a, 0] = sx * (1 + sy * eta) * (1 + sz * zeta) / 8.0 * (2.0 / h)
            grads[q, a, 1] = sy * (1 + sx * xi) * (1 + sz * zeta) / 8.0 * (2.0 / h)
            grads[q, a, 2] = sz * (1 + sx * xi) * (1 + sy * eta) / 8.0 * (2.0 / h)
    w = np.full(8, (h / 2.0) ** 3)
    return grads, w


def _hex_node_signs():
    """Reference-element corner signs, node order = x fastest (lexicographic)."""
    return [
        (sx, sy, sz)
        for sz in (-1, 1)
        for sy in (-1, 1)
        for sx in (-1, 1)
    ]


def _patch_stencil_3d(Ke: np.ndarray) -> np.ndarray:
    """Assemble 2x2x2 elements on a 3^3 node patch; return center-row stencil."""
    patch = np.zeros((27, 27))
    node = lambda i, j, k: 9 * k + 3 * j + i
    for ex in range(2):
        for ey in range(2):
            for ez in range(2):
                loc = []
                for sz in (0, 1):
                    for sy in (0, 1):
                        for sx in (0, 1):
                            loc.append(node(ex + sx, ey + sy, ez + sz))
                for a in range(8):
                    for b in range(8):
                        patch[loc[a], loc[b]] += Ke[a, b]
    center = node(1, 1, 1)
    st = np.zeros((3, 3, 3))
    for i in range(3):
        for j in range(3):
            for k in range(3):
                st[i, j, k] = patch[center, node(i, j, k)]
    return st


def _hex_stiffness_elasticity(E: float, nu: float, h: float) -> np.ndarray:
    """24x24 Q1 hexahedral stiffness for isotropic linear elasticity."""
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    # Voigt elasticity tensor (xx, yy, zz, yz, xz, xy).
    C = np.zeros((6, 6))
    C[:3, :3] = lam
    C[np.arange(3), np.arange(3)] += 2 * mu
    C[3:, 3:] = np.eye(3) * mu

    grads, w = _q1_gradients_3d(h)
    Ke = np.zeros((24, 24))
    for q in range(8):
        B = np.zeros((6, 24))
        for a in range(8):
            gx, gy, gz = grads[q, a]
            c = 3 * a
            B[0, c] = gx
            B[1, c + 1] = gy
            B[2, c + 2] = gz
            B[3, c + 1] = gz
            B[3, c + 2] = gy
            B[4, c] = gz
            B[4, c + 2] = gx
            B[5, c] = gy
            B[5, c + 1] = gx
        Ke += w[q] * B.T @ C @ B
    return Ke


def elasticity_3d(
    nx: int,
    ny: int | None = None,
    nz: int | None = None,
    E: float = 1e5,
    nu: float = 0.3,
):
    """3D linear elasticity on a Q1 hexahedral grid (BASELINE.json:10, config 4).

    Nodes form an (nx, ny, nz) grid; the x=0 face is Dirichlet-fixed
    (cantilever), leaving an SPD system with 3 dofs/node and 27-point 3x3
    block structure.  Returns ``(A_csr, B, coords)`` where ``B`` is the
    (n_dof, 6) rigid-body-mode near-nullspace for smoothed aggregation and
    ``coords`` the (n_nodes, 3) free-node coordinates.
    """
    ny, nz = ny or nx, nz or nx
    h = 1.0
    Ke = _hex_stiffness_elasticity(E, nu, h)

    shape = (nx, ny, nz)
    node_id = np.arange(np.prod(shape)).reshape(shape)
    free = np.ones(shape, dtype=bool)
    free[0, :, :] = False  # clamp x=0 face
    free_ids = -np.ones(np.prod(shape), dtype=np.int64)
    free_ids[node_id[free].ravel()] = np.arange(free.sum())
    n_free = int(free.sum())

    # Element connectivity (vectorized): elements are (nx-1, ny-1, nz-1).
    ex, ey, ez = np.meshgrid(
        np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1), indexing="ij"
    )
    ex, ey, ez = ex.ravel(), ey.ravel(), ez.ravel()
    conn = []
    for sz in (0, 1):
        for sy in (0, 1):
            for sx in (0, 1):
                conn.append(node_id[ex + sx, ey + sy, ez + sz])
    conn = np.stack(conn, axis=1)  # (n_el, 8), matches _hex_node_signs order
    fconn = free_ids[conn]  # (n_el, 8); -1 where clamped

    # Scatter all element matrices (dense blocks of the 24x24 Ke).
    dof = fconn[:, :, None] * 3 + np.arange(3)[None, None, :]  # (n_el, 8, 3)
    dof = dof.reshape(-1, 24)
    dof = np.where(fconn.repeat(3, axis=1) >= 0, dof, -1)
    rows = np.repeat(dof[:, :, None], 24, axis=2).ravel()
    colsm = np.repeat(dof[:, None, :], 24, axis=1).ravel()
    vals = np.tile(Ke.ravel(), dof.shape[0])
    keep = (rows >= 0) & (colsm >= 0)
    A = sp.coo_matrix(
        (vals[keep], (rows[keep], colsm[keep])), shape=(3 * n_free, 3 * n_free)
    ).tocsr()
    A.sum_duplicates()

    # Rigid body modes on free nodes.
    xs, ys, zs = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    coords = np.stack([xs[free], ys[free], zs[free]], axis=1).astype(np.float64) * h
    c0 = coords - coords.mean(axis=0)
    B = np.zeros((3 * n_free, 6))
    for d in range(3):
        B[d::3, d] = 1.0
    # rotations: r x u patterns
    B[0::3, 3], B[1::3, 3] = -c0[:, 1], c0[:, 0]  # rot z
    B[1::3, 4], B[2::3, 4] = -c0[:, 2], c0[:, 1]  # rot x
    B[0::3, 5], B[2::3, 5] = c0[:, 2], -c0[:, 0]  # rot y
    return A, B, coords


def convection_diffusion_2d(
    nx: int,
    ny: int | None = None,
    epsilon: float = 1e-2,
    velocity: tuple[float, float] = (1.0, 2.0),
) -> sp.csr_matrix:
    """Nonsymmetric 2D convection-diffusion  -eps*Lap(u) + v . grad(u)
    on a regular grid (h = 1/(n+1)), first-order upwind convection.

    The standard nonsymmetric AMG/Krylov test problem (solver libraries in
    this domain pair it with GMRES/BiCGStab; CG is inapplicable).  Upwinding
    keeps the operator an M-matrix, so classical coarsening still applies.
    """
    ny = ny or nx
    h = 1.0 / (nx + 1)
    bx, by = float(velocity[0]), float(velocity[1])
    st = np.zeros((3, 3))
    # diffusion (5-point), scaled by eps/h^2; row-scale by h^2 for conditioning
    st[1, 1] += 4.0 * epsilon
    st[0, 1] += -epsilon
    st[2, 1] += -epsilon
    st[1, 0] += -epsilon
    st[1, 2] += -epsilon
    # upwind convection, scaled h (after the h^2 row scaling): b>0 uses the
    # backward difference (coupling to the upwind neighbor)
    if bx >= 0:
        st[1, 1] += bx * h
        st[0, 1] += -bx * h
    else:
        st[1, 1] += -bx * h
        st[2, 1] += bx * h
    if by >= 0:
        st[1, 1] += by * h
        st[1, 0] += -by * h
    else:
        st[1, 1] += -by * h
        st[1, 2] += by * h
    return stencil_grid(st, (nx, ny))


def default_rhs(n: int, seed: int = 0, dtype=np.float64) -> np.ndarray:
    """Deterministic random right-hand side, unit norm."""
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(n).astype(dtype)
    return b / np.linalg.norm(b)
