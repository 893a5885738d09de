"""Occupancy grids for K3 (close + connected-component labelling), shared
by the port's CPU and card tests, which import it by name.  numpy only: the
card tests import no JAX."""
import numpy as np


def serpentine(G):
    """One winding component: full rows every 4 rows (3 empty rows stay
    open under the close), joined at alternating ends; its path is about
    G * G / 4 cells long, so 256 rounds leave it unconverged for G >= 48."""
    occ = np.zeros((G, G), np.int32)
    for k, r in enumerate(range(0, G, 4)):
        occ[r] = 1
        if r + 4 < G:
            occ[r + 1:r + 4, G - 1 if k % 2 == 0 else 0] = 1
    return occ


def edge_grids(G):
    """Grids built to break a kernel that splits the grid into strips of
    rows and words of columns, each (G, G) int32: a one-cell-wide vertical
    line on column 31 above the middle and on column 32 below it (a word
    and warp edge, joined through one corner); the two diagonals (chains
    joined only through corners, across every strip boundary); sparse
    diagonal pairs (the close leaves them apart; each joined through a
    corner); a checkerboard (the close fills it to the whole grid); a plus
    sign that touches all four edges."""
    idx = np.arange(G)
    line = np.zeros((G, G), np.int32)
    line[:G // 2, min(31, G - 1)] = 1
    line[G // 2:, min(32, G - 1)] = 1
    diag = np.zeros((G, G), np.int32)
    diag[idx, idx] = 1
    diag[idx, G - 1 - idx] = 2
    pairs = np.zeros((G, G), np.int32)
    for r in range(1, G - 2, 5):
        for c in range(1 + r % 3, G - 2, 6):
            pairs[r, c] = pairs[r + 1, c + 1] = 1
    checker = ((idx[:, None] + idx[None, :]) % 2).astype(np.int32)
    plus = np.zeros((G, G), np.int32)
    plus[G // 2, :] = 1
    plus[:, G // 3] = 3
    return [line, diag, pairs, checker, plus]


def grids(L, G, seed=0):
    """(L, G, G) int32: the serpentine, an empty and a full grid, the edge
    grids, then random counts (0-3) at densities spread over 0.05-0.6; the
    first L of them."""
    rng = np.random.default_rng(seed)
    fixed = [serpentine(G), np.zeros((G, G), np.int32),
             np.ones((G, G), np.int32)] + edge_grids(G)
    n_rand = max(L - len(fixed), 3)
    rand = [((rng.random((G, G)) < d) * rng.integers(1, 4, (G, G)))
            .astype(np.int32) for d in np.linspace(0.05, 0.6, n_rand)]
    return np.stack((fixed + rand)[:L])
