"""Graph analysis on a sparse coupling matrix — the csgraph tier.

Walks the spsparse_tpu.graph API on a synthetic "mesh coupling" matrix
(the reference library's regridding domain): connectivity audit, hop
distances, an MST backbone, and the Laplacian feeding the solver tier —
then the same BFS on an 8-device virtual mesh via dist.graph.

Run:  python examples/graph_analysis.py
"""

import os

import numpy as np

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from jax.sharding import Mesh  # noqa: E402

from spsparse_tpu import CooBuilder, coo_kronsum, coo_diags  # noqa: E402
from spsparse_tpu.graph import (  # noqa: E402
    bfs_levels, connected_components, laplacian, minimum_spanning_tree,
    shortest_path, structural_rank)
from spsparse_tpu.dist import (  # noqa: E402
    partition_rows, dist_bfs_levels, dist_connected_components)
from spsparse_tpu.solvers import lanczos_eigsh  # noqa: E402


def main():
    rng = np.random.default_rng(0)

    # A 2-D grid coupling (kronsum of 1-D chains) plus random long-range
    # couplings — two disconnected patches.
    n1 = 12
    chain = coo_diags([1.0, 1.0], [1, -1], (n1, n1), dtype=np.float64)
    grid = coo_kronsum(chain, chain)            # (144, 144) 2-D adjacency
    n = int(grid.shape[0])

    b = CooBuilder((2 * n, 2 * n), dtype=np.float64)
    gi, gv = grid.to_lists()
    gi = np.asarray(gi).reshape(len(gv), 2)
    b.add_many(gi, np.asarray(gv))                       # patch 1
    b.add_many(gi + n, np.asarray(gv))                   # patch 2 (shifted)
    extra = rng.integers(0, n, (30, 2))                  # intra-patch links
    extra = extra[extra[:, 0] != extra[:, 1]]
    ew = rng.uniform(0.5, 2.0, len(extra))
    b.add_many(extra, ew)
    b.add_many(extra[:, ::-1], ew)           # keep the adjacency symmetric
    A = b.build().consolidate((0, 1))
    N = int(A.shape[0])

    nc, labels = connected_components(A)
    print(f"graph: {N} nodes, {int(A.nnz)} entries, "
          f"{nc} weakly-connected components")
    print(f"structural rank: {structural_rank(A)}")

    lv = np.asarray(bfs_levels(A, 0, directed=False))
    reach = np.isfinite(lv)
    print(f"BFS from node 0: {int(reach.sum())} reachable, "
          f"eccentricity {int(lv[reach].max())}")

    d = np.asarray(shortest_path(A, indices=[0], directed=False))[0]
    print(f"weighted SSSP from 0: max finite dist "
          f"{d[np.isfinite(d)].max():.3f}")

    T = minimum_spanning_tree(A)
    _, tv = T.to_lists()
    print(f"MST: {int(T.nnz)} edges (= {N} - {nc}), "
          f"weight {float(np.sum(tv)):.3f}")

    L = laplacian(A, normed=True)
    from spsparse_tpu.ops import best_spmv
    v0 = rng.standard_normal(N)
    evals, _ = lanczos_eigsh(lambda x: best_spmv(L, x), v0,
                             k=4, iters=N, which="SA")  # full Krylov: exact
    print(f"normalized-Laplacian smallest Ritz values: "
          f"{np.round(np.asarray(evals), 6)} "
          f"(# near-zero = # components)")

    # Same analysis, row-partitioned over an 8-device mesh. The
    # distributed BFS follows stored edge directions (row-partitioned
    # layout = tails local), so compare against the directed local BFS.
    mesh = Mesh(np.array(jax.devices()), ("x",))
    part = partition_rows(A, 8)
    lv_dir = np.asarray(bfs_levels(A, 0, directed=True))
    lv_d = np.asarray(dist_bfs_levels(part, [0], mesh)).reshape(-1)[:N]
    lab_d = np.asarray(dist_connected_components(part, mesh))[:N]
    print(f"distributed (8 devices): BFS matches={np.allclose(lv_d, lv_dir)},"
          f" CC matches={np.array_equal(lab_d, np.asarray(labels))}")


if __name__ == "__main__":
    main()
