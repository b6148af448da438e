"""Loop subdivision surfaces -> triangle meshes (host numpy, at build
time): the port's copy of the JAX package's ``io/subdiv.py`` (reference
src/shapes/loopsubdiv.rs).  Each level splits every triangle 1 -> 4 with
Loop's vertex and edge masks; the normals are the subdivided mesh's
area-weighted vertex normals (an approximation of the limit surface's).
"""

from __future__ import annotations

import numpy as np


def loop_subdivide(P, F, levels: int = 3):
    """(V f32, F int32, N f32) of the control mesh P (N, 3), F (M, 3)
    after `levels` subdivisions."""
    V = np.asarray(P, np.float64)
    F = np.asarray(F, np.int64).reshape(-1, 3)
    for _ in range(max(0, levels)):
        V, F = _subdivide_once(V, F)
    N = _vertex_normals(V, F)
    return V.astype(np.float32), F.astype(np.int32), N.astype(np.float32)


def _edges_of(F):
    e = np.concatenate([F[:, [0, 1]], F[:, [1, 2]], F[:, [2, 0]]])
    e_sorted = np.sort(e, axis=1)
    uniq, inv = np.unique(e_sorted, axis=0, return_inverse=True)
    return e, uniq, inv


def _subdivide_once(V, F):
    n_v = len(V)
    _, uniq_e, inv = _edges_of(F)
    n_e = len(uniq_e)

    # adjacency: vertex valence and neighbor sums
    val = np.zeros(n_v, np.int64)
    nb_sum = np.zeros((n_v, 3), np.float64)
    np.add.at(val, uniq_e[:, 0], 1)
    np.add.at(val, uniq_e[:, 1], 1)
    np.add.at(nb_sum, uniq_e[:, 0], V[uniq_e[:, 1]])
    np.add.at(nb_sum, uniq_e[:, 1], V[uniq_e[:, 0]])

    # edge -> adjacent face opposite-vertex sum (for interior edge points)
    opp_sum = np.zeros((n_e, 3), np.float64)
    edge_face_count = np.zeros(n_e, np.int64)
    opp = np.concatenate([F[:, 2], F[:, 0], F[:, 1]])
    np.add.at(opp_sum, inv, V[opp])
    np.add.at(edge_face_count, inv, 1)

    boundary_e = edge_face_count < 2
    # boundary vertices: any vertex on a boundary edge
    boundary_v = np.zeros(n_v, bool)
    boundary_v[uniq_e[boundary_e].ravel()] = True

    # --- even (old) vertices: Loop vertex mask ---
    n = val.astype(np.float64)
    beta = np.where(
        n == 3, 3.0 / 16.0, 3.0 / (8.0 * np.maximum(n, 3))
    )
    new_even = (1.0 - n * beta)[:, None] * V + beta[:, None] * nb_sum
    # boundary rule: 3/4 v + 1/8 (boundary neighbors) — approximate with
    # neighbor sum restricted to boundary edges
    b_nb_sum = np.zeros((n_v, 3), np.float64)
    b_val = np.zeros(n_v, np.int64)
    be = uniq_e[boundary_e]
    np.add.at(b_nb_sum, be[:, 0], V[be[:, 1]])
    np.add.at(b_nb_sum, be[:, 1], V[be[:, 0]])
    np.add.at(b_val, be[:, 0], 1)
    np.add.at(b_val, be[:, 1], 1)
    with np.errstate(invalid="ignore"):
        b_even = 0.75 * V + 0.125 * b_nb_sum
    ok_b = b_val == 2
    new_even = np.where((boundary_v & ok_b)[:, None], b_even, new_even)

    # --- odd (edge) vertices ---
    ends = 0.5 * (V[uniq_e[:, 0]] + V[uniq_e[:, 1]])
    interior = (3.0 / 8.0) * (V[uniq_e[:, 0]] + V[uniq_e[:, 1]]) + (1.0 / 8.0) * opp_sum
    new_odd = np.where(boundary_e[:, None], ends, interior)

    V2 = np.concatenate([new_even, new_odd])
    e01 = n_v + inv[: len(F)]
    e12 = n_v + inv[len(F) : 2 * len(F)]
    e20 = n_v + inv[2 * len(F) :]
    F2 = np.concatenate(
        [
            np.stack([F[:, 0], e01, e20], -1),
            np.stack([F[:, 1], e12, e01], -1),
            np.stack([F[:, 2], e20, e12], -1),
            np.stack([e01, e12, e20], -1),
        ]
    )
    return V2, F2


def _vertex_normals(V, F):
    fn = np.cross(V[F[:, 1]] - V[F[:, 0]], V[F[:, 2]] - V[F[:, 0]])
    N = np.zeros_like(V)
    for k in range(3):
        np.add.at(N, F[:, k], fn)
    lens = np.linalg.norm(N, axis=-1, keepdims=True)
    return N / np.maximum(lens, 1e-12)
