"""spsparse-tpu command line: inspect and convert sparse-matrix files.

Commands::

    python -m spsparse_tpu.tools info FILE             # container + arrays
    python -m spsparse_tpu.tools convert SRC DST       # re-container
        [--version {1,2,4,5}]                          # target (default 5)
    python -m spsparse_tpu.tools stats FILE VNAME      # matrix statistics
    python -m spsparse_tpu.tools solve FILE VNAME      # iterative solve
        [--rhs FILE:VNAME] [--method cg|bicgstab|gmres|minres|direct]
        [--precond none|jacobi|blockjacobi|ilu] [--iters N] [--out FILE]
    python -m spsparse_tpu.tools eigs FILE VNAME       # spectral analysis
        [--k N] [--which LA|SA|LM|SM|LR|SR] [--svd] [--iters N]
    python -m spsparse_tpu.tools reorder SRC DST VNAME # RCM bandwidth cut
    python -m spsparse_tpu.tools graph FILE VNAME      # graph analysis
        [--op cc|sssp|mst|laplacian] [--source N] [--undirected]
        [--strong] [--normed] [--out FILE]

Works on classic NetCDF (CDF-1/2/5, in-tree codec) and NetCDF-4/HDF5
(h5py) containers holding the reference spsparse schema.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

# File tools never need an accelerator; forcing the CPU backend avoids
# reserving device memory for a metadata query.
try:
    import jax

    jax.config.update("jax_platforms", "cpu")
except Exception:  # pragma: no cover
    pass


def _nc(path):
    from ..io.netcdf import _read_any

    return _read_any(path)


def _schema_arrays(nc):
    """vnames following the spsparse schema (have .info/.indices/.vals)."""
    names = {v.name for v in nc.vars}
    out = []
    for n in names:
        if n.endswith(".info") and (n[:-5] + ".indices") in names:
            out.append(n[:-5])
    return sorted(out)


def cmd_info(args) -> int:
    nc = _nc(args.file)
    kind = "NetCDF-4/HDF5" if nc.version == 4 else f"classic CDF-{nc.version}"
    print(f"{args.file}: {kind}")
    print(f"  dimensions: " + ", ".join(
        f"{d.name}={d.size}" for d in nc.dims))
    for v in nc.vars:
        dims = "x".join(str(nc.dims[d].size) for d in v.dimids) or "scalar"
        print(f"  var {v.name}: type={v.nc_type} [{dims}]")
    arrays = _schema_arrays(nc)
    if arrays:
        print("  spsparse arrays: " + ", ".join(arrays))
    return 0


def cmd_convert(args) -> int:
    from ..io.netcdf import load_netcdf, save_netcdf

    nc = _nc(args.src)
    arrays = _schema_arrays(nc)
    if not arrays:
        print("no spsparse-schema arrays found", file=sys.stderr)
        return 1
    loaded = {v: load_netcdf(args.src, v) for v in arrays}
    save_netcdf(args.dst, loaded, version=args.version)
    print(f"wrote {args.dst} (version {args.version}) with "
          f"{len(loaded)} array(s): {', '.join(arrays)}")
    return 0


def cmd_stats(args) -> int:
    from ..io.netcdf import load_netcdf

    A = load_netcdf(args.file, args.vname)
    idx, vals = A.to_lists()
    vals = np.asarray(vals)
    nnz = len(vals)
    stats = {
        "vname": args.vname,
        "shape": list(A.shape),
        "nnz": nnz,
        "density": nnz / max(float(np.prod(A.shape)), 1.0),
        "val_min": float(vals.min()) if nnz else None,
        "val_max": float(vals.max()) if nnz else None,
        "val_sum": float(vals.sum()) if nnz else 0.0,
    }
    if A.rank == 2 and nnz:
        rows = np.asarray([i[0] for i in idx])
        offs = np.asarray([i[1] - i[0] for i in idx])
        counts = np.bincount(rows, minlength=A.shape[0])
        stats["rows_present"] = int((counts > 0).sum())
        stats["max_row_nnz"] = int(counts.max())
        stats["n_diagonals"] = int(np.unique(offs).size)
        stats["bandwidth"] = int(np.abs(offs).max())
    print(json.dumps(stats, indent=1))
    return 0


def cmd_solve(args) -> int:
    import jax.numpy as jnp

    from ..core.structure import to_csr
    from ..io.netcdf import load_netcdf, save_netcdf
    from ..ops.spmm import spmv
    from ..solvers import (bicgstab_solve, block_jacobi_preconditioner,
                           extract_diagonal, gmres_solve,
                           jacobi_preconditioner, pcg_solve)
    from .. import CooBuilder

    A = load_netcdf(args.file, args.vname)
    if A.rank != 2 or A.shape[0] != A.shape[1]:
        print("solve requires a square rank-2 array", file=sys.stderr)
        return 1
    n = A.shape[0]
    if args.rhs:
        path, _, vname = args.rhs.partition(":")
        rhs = np.asarray(load_netcdf(path, vname or "b").to_dense())
    else:
        rhs = np.ones(n)
    csr = to_csr(A)
    mv = lambda v: spmv(csr, v)  # noqa: E731

    minv = None
    if args.precond == "jacobi":
        minv = jacobi_preconditioner(extract_diagonal(csr))
    elif args.precond == "blockjacobi":
        minv = block_jacobi_preconditioner(A, bs=min(128, n))
    elif args.precond == "ilu":
        from ..solvers import spilu
        minv = spilu(A).solve
    b = jnp.asarray(rhs)
    if args.method == "direct":
        from ..solvers import splu
        if args.precond != "none":
            print("note: direct ignores --precond", file=sys.stderr)
            args.precond = "none"
        x = splu(A, permc_spec="RCM").solve(b)
        rs = jnp.vdot(b - mv(x), b - mv(x))
        args.iters = 0
    elif args.method == "cg":
        x, rs = pcg_solve(mv, b, iters=args.iters, minv=minv)
    elif args.method == "bicgstab":
        x, rs = bicgstab_solve(mv, b, iters=args.iters, minv=minv)
    elif args.method == "cgs":
        from ..solvers import cgs_solve
        x, rs = cgs_solve(mv, b, iters=args.iters, minv=minv)
    elif args.method in ("minres", "tfqmr"):
        from ..solvers import minres_solve, tfqmr_solve
        if args.precond != "none":
            # these take no preconditioner; reporting one as applied
            # would falsify CLI comparisons.
            print(f"note: {args.method} ignores --precond (running "
                  "unpreconditioned)", file=sys.stderr)
            args.precond = "none"
        fn = minres_solve if args.method == "minres" else tfqmr_solve
        x, rs = fn(mv, b, iters=args.iters)
    else:
        x, rs = gmres_solve(mv, b, m=min(30, n),
                            restarts=max(1, args.iters // 30), minv=minv)
    x = np.asarray(x)
    print(json.dumps({"method": args.method, "precond": args.precond,
                      "n": n, "iters": args.iters,
                      "residual_norm": float(np.sqrt(float(rs))),
                      "x_min": float(x.min()), "x_max": float(x.max())},
                     indent=1))
    if args.out:
        bx = CooBuilder((n,), dtype=np.float64)
        bx.add_many(np.arange(n)[:, None], x.astype(np.float64))
        save_netcdf(args.out, {"x": bx.build()})
        print(f"wrote {args.out} (x as rank-1 spsparse array)")
    return 0


def cmd_eigs(args) -> int:
    import jax.numpy as jnp

    from ..core.structure import to_csr
    from ..io.netcdf import load_netcdf
    from ..ops.spmm import spmv
    from ..solvers import lanczos_eigsh, svds_lanczos

    A = load_netcdf(args.file, args.vname)
    if A.rank != 2:
        print("eigs requires a rank-2 array", file=sys.stderr)
        return 1
    rng = np.random.default_rng(0)
    csr = to_csr(A)
    if args.svd:
        csrT = to_csr(A, transpose=True)
        _, s, _ = svds_lanczos(
            lambda v: spmv(csr, v), lambda u: spmv(csrT, u),
            jnp.asarray(rng.standard_normal(A.shape[1])),
            k=args.k, iters=args.iters)
        print(json.dumps({"vname": args.vname, "kind": "singular_values",
                          "k": args.k,
                          "values": [float(v) for v in np.asarray(s)]},
                         indent=1))
        return 0
    if A.shape[0] != A.shape[1]:
        print("--svd required for rectangular arrays", file=sys.stderr)
        return 1
    v0 = jnp.asarray(rng.standard_normal(A.shape[0]))
    if args.which in ("LA", "SA"):
        vals, _ = lanczos_eigsh(lambda v: spmv(csr, v), v0,
                                k=args.k, iters=args.iters,
                                which=args.which)
        out_vals = [float(v) for v in np.asarray(vals)]
        note = "operator treated as symmetric"
    else:                                  # LM/SM/LR/SR: general Arnoldi
        from ..solvers import arnoldi_eigs
        vals, _ = arnoldi_eigs(lambda v: spmv(csr, v), v0,
                               k=args.k, iters=args.iters,
                               which=args.which)
        out_vals = [[float(v.real), float(v.imag)] for v in vals]
        note = "general operator (Arnoldi); values as [re, im]"
    print(json.dumps({"vname": args.vname, "kind": "eigenvalues",
                      "which": args.which, "k": args.k,
                      "note": note, "values": out_vals},
                     indent=1))
    return 0


def cmd_reorder(args) -> int:
    from .. import bandwidth, coo_permute, rcm_permutation, CooBuilder
    from ..io.netcdf import load_netcdf, save_netcdf

    A = load_netcdf(args.src, args.vname)
    if A.rank != 2 or A.shape[0] != A.shape[1]:
        print("reorder requires a square rank-2 array", file=sys.stderr)
        return 1
    bw0 = bandwidth(A)
    perm = rcm_permutation(A)
    B = coo_permute(A, perm).consolidate((0, 1))
    bw1 = bandwidth(B)
    out = {args.vname: B}
    pb = CooBuilder((A.shape[0],), dtype=np.float64)
    pb.add_many(np.arange(A.shape[0])[:, None], perm.astype(np.float64))
    out[args.vname + ".perm"] = pb.build()
    save_netcdf(args.dst, out)
    print(json.dumps({"vname": args.vname, "bandwidth_before": bw0,
                      "bandwidth_after": bw1,
                      "perm_var": args.vname + ".perm",
                      "dst": args.dst}, indent=1))
    return 0


def cmd_graph(args) -> int:
    from ..io.netcdf import load_netcdf, save_netcdf
    from .. import CooBuilder

    A = load_netcdf(args.file, args.vname)
    if A.rank != 2 or A.shape[0] != A.shape[1]:
        print("graph requires a square rank-2 array", file=sys.stderr)
        return 1
    n = A.shape[0]
    out = {"vname": args.vname, "op": args.op, "n": n, "nnz": int(A.nnz)}
    if args.op == "cc":
        from ..graph import connected_components
        nc, lab = connected_components(
            A, connection="strong" if args.strong else "weak")
        sizes = np.bincount(np.asarray(lab), minlength=int(nc))
        out.update(n_components=int(nc),
                   largest=int(sizes.max()) if len(sizes) else 0,
                   isolated=int((sizes == 1).sum()))
    elif args.op == "sssp":
        from ..graph import bellman_ford
        d = np.asarray(bellman_ford(A, [args.source],
                                    directed=not args.undirected))[0]
        fin = np.isfinite(d)
        out.update(source=args.source, reachable=int(fin.sum()),
                   max_dist=float(d[fin].max()) if fin.any() else None,
                   mean_dist=float(d[fin].mean()) if fin.any() else None)
        if args.out:
            bx = CooBuilder((n,), dtype=np.float64)
            keep = fin
            bx.add_many(np.nonzero(keep)[0][:, None], d[keep])
            save_netcdf(args.out, {"dist": bx.build()})
            out["dst"] = args.out
    elif args.op == "mst":
        from ..graph import minimum_spanning_tree
        T = minimum_spanning_tree(A)
        iv, vv = T.to_lists()
        out.update(tree_edges=int(T.nnz), tree_weight=float(np.sum(vv)))
        if args.out:
            save_netcdf(args.out, {args.vname + ".mst": T})
            out["dst"] = args.out
    else:  # laplacian
        from ..graph import laplacian
        L = laplacian(A, normed=args.normed)
        if args.out:
            save_netcdf(args.out, {args.vname + ".laplacian": L})
            out["dst"] = args.out
        out.update(laplacian_nnz=int(L.nnz), normed=bool(args.normed))
    print(json.dumps(out, indent=1))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m spsparse_tpu.tools")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("info", help="describe a NetCDF file")
    p.add_argument("file")
    p.set_defaults(fn=cmd_info)
    p = sub.add_parser("convert", help="convert between container flavors")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--version", type=int, default=5, choices=(1, 2, 4, 5))
    p.set_defaults(fn=cmd_convert)
    p = sub.add_parser("stats", help="sparse-matrix statistics")
    p.add_argument("file")
    p.add_argument("vname")
    p.set_defaults(fn=cmd_stats)
    p = sub.add_parser("solve", help="iterative solve A x = b")
    p.add_argument("file")
    p.add_argument("vname")
    p.add_argument("--rhs", default=None,
                   help="FILE:VNAME rank-1 rhs (default: ones)")
    p.add_argument("--method", default="cg",
                   choices=("cg", "bicgstab", "cgs", "tfqmr", "gmres",
                            "minres", "direct"))
    p.add_argument("--precond", default="jacobi",
                   choices=("none", "jacobi", "blockjacobi", "ilu"))
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_solve)
    p = sub.add_parser("eigs", help="extreme eigen/singular values")
    p.add_argument("file")
    p.add_argument("vname")
    p.add_argument("--k", type=int, default=4)
    p.add_argument("--which", default="LA",
                   choices=("LA", "SA", "LM", "SM", "LR", "SR"),
                   help="LA/SA: symmetric Lanczos; LM/SM/LR/SR: "
                        "general Arnoldi (complex output)")
    p.add_argument("--svd", action="store_true",
                   help="singular values (Golub-Kahan) instead of eigsh")
    p.add_argument("--iters", type=int, default=48)
    p.set_defaults(fn=cmd_eigs)
    p = sub.add_parser("reorder",
                       help="RCM-reorder a square array (writes the "
                            "permuted array + permutation)")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("vname")
    p.set_defaults(fn=cmd_reorder)
    p = sub.add_parser("graph",
                       help="graph analysis (connected components, "
                            "shortest paths, MST, Laplacian)")
    p.add_argument("file")
    p.add_argument("vname")
    p.add_argument("--op", default="cc",
                   choices=("cc", "sssp", "mst", "laplacian"))
    p.add_argument("--source", type=int, default=0,
                   help="sssp source node")
    p.add_argument("--undirected", action="store_true")
    p.add_argument("--strong", action="store_true",
                   help="strong components (cc)")
    p.add_argument("--normed", action="store_true",
                   help="normalized Laplacian")
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_graph)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
