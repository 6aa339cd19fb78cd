"""CLI tools tests (in-process invocation of the argparse main)."""

import json

import numpy as np

from spsparse_tpu import CooBuilder
from spsparse_tpu.io import save_netcdf
from spsparse_tpu.tools.__main__ import main


def _mk(tmp_path):
    b = CooBuilder((10, 12), dtype=np.float64)
    b.add((1, 3), 2.0)
    b.add((4, 4), 5.0)
    p = str(tmp_path / "m.nc")
    save_netcdf(p, {"M": b.build()})
    return p


def test_info(tmp_path, capsys):
    p = _mk(tmp_path)
    assert main(["info", p]) == 0
    out = capsys.readouterr().out
    assert "classic CDF-5" in out and "spsparse arrays: M" in out


def test_convert_and_stats(tmp_path, capsys):
    p = _mk(tmp_path)
    q = str(tmp_path / "m4.nc")
    assert main(["convert", p, q, "--version", "4"]) == 0
    capsys.readouterr()
    assert main(["stats", q, "M"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["nnz"] == 2 and stats["shape"] == [10, 12]
    assert stats["bandwidth"] == 2


def test_convert_no_arrays(tmp_path, capsys):
    from spsparse_tpu.io import NcFile, write_cdf
    p = str(tmp_path / "empty.nc")
    write_cdf(p, NcFile(version=5))
    assert main(["convert", p, str(tmp_path / "o.nc")]) == 1


def test_solve_cg_jacobi_and_output(tmp_path, capsys):
    rng = np.random.default_rng(0)
    n = 24
    A = np.zeros((n, n))
    off = rng.uniform(-0.3, 0.3, n - 1)
    A[np.arange(n - 1), np.arange(1, n)] = off
    A[np.arange(1, n), np.arange(n - 1)] = off
    A[np.arange(n), np.arange(n)] = np.abs(A).sum(1) + rng.uniform(1, 2, n)
    ii, jj = np.nonzero(A)
    b = CooBuilder((n, n), dtype=np.float64)
    b.add_many(np.stack([ii, jj], 1), A[ii, jj])
    p = str(tmp_path / "spd.nc")
    save_netcdf(p, {"A": b.build()})
    xout = str(tmp_path / "x.nc")
    assert main(["solve", p, "A", "--iters", "60", "--out", xout]) == 0
    out = capsys.readouterr().out
    res = json.loads(out[: out.index("wrote")])
    assert res["residual_norm"] < 1e-8
    from spsparse_tpu.io import load_netcdf
    x = np.asarray(load_netcdf(xout, "x").to_dense())
    np.testing.assert_allclose(x, np.linalg.solve(A, np.ones(n)),
                               rtol=1e-7, atol=1e-9)


def test_solve_gmres_nonsquare_guard(tmp_path, capsys):
    p = _mk(tmp_path)        # 10x12 — not square
    assert main(["solve", p, "M"]) == 1


def _mk_spd(tmp_path, n=24):
    rng = np.random.default_rng(3)
    lo = rng.uniform(0.1, 0.4, n - 1)
    d = rng.uniform(1.5, 2.5, n)
    A = np.diag(d) + np.diag(lo, 1) + np.diag(lo, -1)
    ii, jj = np.nonzero(A)
    b = CooBuilder((n, n), dtype=np.float64)
    b.add_many(np.stack([ii, jj], 1), A[ii, jj])
    p = str(tmp_path / "spd.nc")
    save_netcdf(p, {"A": b.build()})
    return p, A


def test_eigs_and_svd(tmp_path, capsys):
    p, A = _mk_spd(tmp_path)
    assert main(["eigs", p, "A", "--k", "2", "--which", "LA"]) == 0
    out = json.loads(capsys.readouterr().out)
    lam = np.linalg.eigvalsh(A)
    np.testing.assert_allclose(out["values"], lam[-2:], rtol=1e-8)

    assert main(["eigs", p, "A", "--k", "2", "--svd"]) == 0
    out = json.loads(capsys.readouterr().out)
    s = np.linalg.svd(A, compute_uv=False)
    np.testing.assert_allclose(out["values"], s[:2], rtol=1e-8)


def test_solve_minres(tmp_path, capsys):
    p, A = _mk_spd(tmp_path)
    assert main(["solve", p, "A", "--method", "minres",
                 "--iters", "60"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["residual_norm"] < 1e-8


def test_reorder(tmp_path, capsys):
    rng = np.random.default_rng(4)
    n = 32
    A = np.zeros((n, n))
    v = rng.uniform(0.5, 1.5, n - 1)
    A[np.arange(n - 1), np.arange(1, n)] = v
    A[np.arange(1, n), np.arange(n - 1)] = v
    perm = rng.permutation(n)
    S = A[np.ix_(perm, perm)]
    ii, jj = np.nonzero(S)
    b = CooBuilder((n, n), dtype=np.float64)
    b.add_many(np.stack([ii, jj], 1), S[ii, jj])
    src = str(tmp_path / "scr.nc")
    save_netcdf(src, {"A": b.build()})
    dst = str(tmp_path / "rcm.nc")
    assert main(["reorder", src, dst, "A"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["bandwidth_after"] <= 2 < out["bandwidth_before"]

    # The written file round-trips and the stored permutation undoes it.
    from spsparse_tpu.io import load_netcdf
    B = load_netcdf(dst, "A", rank=2)
    pv = np.asarray(load_netcdf(dst, "A.perm", rank=1).to_dense()
                    ).astype(np.int64)
    Bd = np.asarray(B.to_dense())
    np.testing.assert_array_equal(Bd, S[np.ix_(pv, pv)])


def _mk_graph(tmp_path, symmetric=True):
    rng = np.random.default_rng(7)
    n = 16
    dense = np.zeros((n, n))
    r, c = rng.integers(0, n, 40), rng.integers(0, n, 40)
    w = rng.uniform(0.5, 3.0, 40)
    for i, j, v in zip(r, c, w):
        if i != j:
            dense[i, j] = v
    if symmetric:
        dense = np.maximum(dense, dense.T)
    rr, cc = dense.nonzero()
    b = CooBuilder((n, n), dtype=np.float64)
    b.add_many(np.stack([rr, cc], 1), dense[rr, cc])
    p = str(tmp_path / "g.nc")
    save_netcdf(p, {"G": b.build()})
    return p, dense


def test_graph_cc(tmp_path, capsys):
    import scipy.sparse as sps
    import scipy.sparse.csgraph as cs
    p, dense = _mk_graph(tmp_path)
    assert main(["graph", p, "G", "--op", "cc"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["n_components"] == cs.connected_components(
        sps.csr_matrix(dense), connection="weak")[0]


def test_graph_sssp_and_output(tmp_path, capsys):
    import scipy.sparse as sps
    import scipy.sparse.csgraph as cs
    p, dense = _mk_graph(tmp_path)
    out_p = str(tmp_path / "d.nc")
    assert main(["graph", p, "G", "--op", "sssp", "--source", "0",
                 "--out", out_p]) == 0
    out = json.loads(capsys.readouterr().out)
    ref = cs.bellman_ford(sps.csr_matrix(dense), indices=[0])[0]
    assert out["reachable"] == int(np.isfinite(ref).sum())
    from spsparse_tpu.io import load_netcdf
    d = np.asarray(load_netcdf(out_p, "dist").to_dense())
    fin = np.isfinite(ref)
    # source dist 0 is a structural zero in the sparse output; compare
    # the nonzero reachable entries
    np.testing.assert_allclose(d[fin], np.where(fin, ref, 0)[fin])


def test_graph_mst(tmp_path, capsys):
    import scipy.sparse as sps
    import scipy.sparse.csgraph as cs
    p, dense = _mk_graph(tmp_path)
    assert main(["graph", p, "G", "--op", "mst"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert np.isclose(out["tree_weight"],
                      cs.minimum_spanning_tree(sps.csr_matrix(dense)).sum())


def test_graph_laplacian_roundtrip(tmp_path, capsys):
    p, dense = _mk_graph(tmp_path)
    out_p = str(tmp_path / "l.nc")
    assert main(["graph", p, "G", "--op", "laplacian", "--out", out_p]) == 0
    json.loads(capsys.readouterr().out)
    import scipy.sparse as sps
    import scipy.sparse.csgraph as cs
    from spsparse_tpu.io import load_netcdf
    L = np.asarray(load_netcdf(out_p, "G.laplacian").to_dense())
    np.testing.assert_allclose(
        L, cs.laplacian(sps.csr_matrix(dense), normed=False).toarray())


def test_solve_tfqmr_and_cgs(tmp_path, capsys):
    rng = np.random.default_rng(3)
    n = 20
    A = np.diag(rng.uniform(2, 4, n))
    A[np.arange(n - 1), np.arange(1, n)] = rng.uniform(-0.5, 0.5, n - 1)
    rr, cc = A.nonzero()
    b = CooBuilder((n, n), dtype=np.float64)
    b.add_many(np.stack([rr, cc], 1), A[rr, cc])
    p = str(tmp_path / "a.nc")
    save_netcdf(p, {"A": b.build()})
    for method in ("tfqmr", "cgs"):
        assert main(["solve", p, "A", "--method", method,
                     "--iters", "30"]) == 0
        out = json.loads(capsys.readouterr().out)
        assert out["residual_norm"] < 1e-8


def test_solve_direct_and_ilu_precond(tmp_path, capsys):
    p, A = _mk_spd(tmp_path)
    assert main(["solve", p, "A", "--method", "direct"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["method"] == "direct" and out["residual_norm"] < 1e-5
    assert main(["solve", p, "A", "--method", "bicgstab",
                 "--precond", "ilu", "--iters", "30"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["precond"] == "ilu" and out["residual_norm"] < 1e-6


def test_eigs_general_arnoldi(tmp_path, capsys):
    # nonsymmetric operator -> LM routes to arnoldi_eigs, [re, im] pairs
    rng = np.random.default_rng(5)
    n = 20
    A = np.triu(rng.standard_normal((n, n)), 1) + np.diag(
        rng.uniform(1, 3, n))
    ii, jj = np.nonzero(A)
    b = CooBuilder((n, n), dtype=np.float64)
    b.add_many(np.stack([ii, jj], 1), A[ii, jj])
    p = str(tmp_path / "gen.nc")
    save_netcdf(p, {"A": b.build()})
    assert main(["eigs", p, "A", "--k", "3", "--which", "LM"]) == 0
    out = json.loads(capsys.readouterr().out)
    got = sorted(abs(complex(re, im)) for re, im in out["values"])
    lam = np.sort(np.abs(np.linalg.eigvals(A)))[-3:]
    np.testing.assert_allclose(got, lam, rtol=1e-5)


def test_apidoc_generates(tmp_path):
    # the Doxygen-apidoc counterpart (reference slib/CMakeLists.txt:32-41)
    from spsparse_tpu.tools.apidoc import generate
    out = tmp_path / "API.md"
    n = generate(str(out))
    assert n > 200
    text = out.read_text()
    assert "SparseCOO" in text and "consolidate" in text
    assert "block_spmm" in text and "use_gpu_kernels" in text
