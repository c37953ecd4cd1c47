"""The 2-D square-lattice Ising model with periodic boundaries (a torus):
an EQUAL factor on each of the 2 x rows x cols nearest-neighbour pairs,
every one sharing weight 0 = ``coupling``, and no field.  With J = 1 at
temperature T an EQUAL factor's weight is 2 J / T; at the critical point
T_c = 2 / ln(1 + sqrt 2) that is ln(1 + sqrt 2).  The checkerboard
2-coloring is exact on a torus of even sides.  The lattice holds no
randomness: ``seed`` is taken for a uniform call."""
import numpy as np

from gpubench import graphs


def make(seed: int, rows: int, cols: int, coupling: float) -> tuple:
    del seed
    if rows % 2 or cols % 2 or rows < 4 or cols < 4:
        raise ValueError("a checkerboard torus needs even sides of 4 or more")
    V = rows * cols
    r, c = np.divmod(np.arange(V, dtype=np.int64), cols)
    right = r * cols + (c + 1) % cols
    down = ((r + 1) % rows) * cols + c
    n_pair = 2 * V
    f_ptr = 2 * np.arange(n_pair + 1, dtype=np.int64)
    e_vid = np.stack([np.concatenate([np.arange(V), np.arange(V)]),
                      np.concatenate([right, down])], axis=1).reshape(-1)
    g = graphs.arrays(np.zeros(V), np.zeros(V), [coupling],
                      np.full(n_pair, graphs.FUNC_EQUAL, np.int32),
                      np.zeros(n_pair, np.int32), f_ptr, e_vid,
                      np.ones(len(e_vid), bool))
    return g, ((r + c) % 2).astype(np.int32)
