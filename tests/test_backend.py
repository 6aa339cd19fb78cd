"""The backend dispatch point, the device peak table and the compile-cache
directory choice."""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spsparse_tpu import CooBuilder


@pytest.mark.parametrize("platform,expect", [("gpu", True), ("cpu", False),
                                             ("rocm", False)])
def test_use_gpu_kernels(platform, expect):
    from spsparse_tpu.core.backend import use_gpu_kernels
    assert use_gpu_kernels(platform) is expect


@pytest.mark.parametrize("platform,dtype,expect", [
    ("gpu", jnp.bfloat16, True), ("gpu", jnp.float32, False),
    ("cpu", jnp.bfloat16, False)])
def test_runs_gpu_kernel(platform, dtype, expect):
    from spsparse_tpu.core.backend import runs_gpu_kernel
    assert runs_gpu_kernel(dtype, platform) is expect


def test_default_platform_is_the_default_device():
    from spsparse_tpu.core.backend import default_platform, use_gpu_kernels
    assert default_platform() == jax.devices()[0].platform == "cpu"
    assert use_gpu_kernels() is False


@pytest.mark.parametrize("dtypes,expect", [
    ((jnp.float32,), jax.lax.Precision.HIGHEST),
    ((jnp.float64,), jax.lax.Precision.HIGHEST),
    ((jnp.bfloat16,), jax.lax.Precision.DEFAULT),
    ((jnp.float32, jnp.bfloat16), jax.lax.Precision.DEFAULT),
])
def test_dot_precision(dtypes, expect):
    from spsparse_tpu.core.backend import dot_precision
    assert dot_precision(*dtypes) == expect


def _operands():
    """One operand of every type ``best_spmv``/``best_spmm`` route, all
    holding the same 200x260 matrix."""
    from spsparse_tpu import to_csr
    from spsparse_tpu.core.bsr import to_bsr
    from spsparse_tpu.core.dia import to_dia
    from spsparse_tpu.core.structure import to_ell
    from spsparse_tpu.core.tiled import to_tiled
    from spsparse_tpu.ops import prepare_dia
    from spsparse_tpu.ops.block_spmm import prepare_tiled_dense
    from spsparse_tpu.ops.general import PreparedGeneral, _prepare_gather

    rng = np.random.default_rng(3)
    n, m = 200, 260
    b = CooBuilder((n, m), dtype=np.float32)
    for off in (-3, 0, 2, 40):
        r = np.arange(max(0, -off), min(n, m - off))
        b.add_many(np.stack([r, r + off], 1),
                   rng.uniform(-1, 1, r.size).astype(np.float32))
    A = b.build()
    hot = CooBuilder((n, m), dtype=np.float32)     # one long row -> entry list
    hot.add_many(np.stack([np.zeros(m, np.int64), np.arange(m)], 1),
                 np.ones(m, np.float32))
    hot.add((7, 3), 2.0)
    hot = hot.build()
    ops = {
        "SparseDIA": to_dia(A),
        "prepared_dia": prepare_dia(to_dia(A)),
        "gather_ell": PreparedGeneral(order=None, prep=_prepare_gather(A)),
        "gather": PreparedGeneral(order=None,
                                  prep=_prepare_gather(hot)),
        "block_f32": prepare_tiled_dense(to_tiled(A)),
        "block_bf16": prepare_tiled_dense(to_tiled(A), dtype=jnp.bfloat16),
        "general_block_bf16": PreparedGeneral(
            order=None, prep=prepare_tiled_dense(to_tiled(A),
                                                 dtype=jnp.bfloat16)),
        "SparseTiledCOO": to_tiled(A),
        "SparseBSR": to_bsr(A, (8, 8)),
        "SparseELL": to_ell(to_csr(A)),
        "SparseCSR": to_csr(A),
        "SparseCOO": A,
    }
    assert type(ops["gather"].prep).__name__ == "PreparedGather"
    dense = {k: np.asarray((hot if k == "gather" else A).to_dense())
             for k in ops}
    return dense, ops


_ROUTES = {
    # operand: (route on gpu, route on cpu)
    "SparseDIA": ("dia_fused", "dia_fused"),
    "prepared_dia": ("dia_fused", "dia_fused"),
    "gather_ell": ("gather_ell", "gather_ell"),
    "gather": ("gather_segment_sum", "gather_segment_sum"),
    "block_f32": ("block_xla", "block_xla"),
    "block_bf16": ("block_pallas", "block_xla"),
    "general_block_bf16": ("block_pallas", "block_xla"),
    "SparseTiledCOO": ("tiled_onehot", "tiled_onehot"),
    "SparseBSR": ("bsr", "bsr"),
    "SparseELL": ("ell", "ell"),
    "SparseCSR": ("csr_segment_sum", "csr_segment_sum"),
    "SparseCOO": ("csr_segment_sum", "csr_segment_sum"),
}


@pytest.fixture(scope="module")
def operands():
    return _operands()


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
@pytest.mark.parametrize("name", sorted(_ROUTES))
def test_spmm_route_per_operand_and_platform(operands, name, platform):
    from spsparse_tpu.ops import spmm_route
    dense, ops = operands
    want = _ROUTES[name][0 if platform == "gpu" else 1]
    assert spmm_route(ops[name], platform) == want
    # the default platform here is the CPU, so best_spmm must produce the
    # CPU route's result: correct against the dense oracle
    if platform == "cpu":
        from spsparse_tpu.ops import best_spmm
        X = np.random.default_rng(4).uniform(-1, 1, (260, 5))
        X = X.astype(np.float32)
        tol = 3e-2 if "bf16" in name else 1e-4
        np.testing.assert_allclose(np.asarray(best_spmm(ops[name], X)),
                                   dense[name] @ X, rtol=tol, atol=tol)


def test_block_kernel_runs_where_routed(monkeypatch, operands):
    """With the platform reported as a GPU, a bf16 block operand goes
    through the Hopper kernel (spied, run in the interpreter) and an f32
    one through the plain form."""
    bs = importlib.import_module("spsparse_tpu.ops.block_spmm")
    backend = importlib.import_module("spsparse_tpu.core.backend")
    calls = []
    real = bs.block_spmm_pallas

    def spy(tcols, blocks, Xp, **kw):
        calls.append(blocks.dtype)
        kw["interpret"] = True
        return real(tcols, blocks, Xp, **kw)

    monkeypatch.setattr(backend, "default_platform", lambda: "gpu")
    monkeypatch.setattr(bs, "block_spmm_pallas", spy)
    dense, ops = operands
    X = np.random.default_rng(5).uniform(-1, 1, (260, 3)).astype(np.float32)
    from spsparse_tpu.ops import best_spmm
    y16 = best_spmm(ops["block_bf16"], X)
    assert calls == [jnp.bfloat16]
    y32 = best_spmm(ops["block_f32"], X)
    assert calls == [jnp.bfloat16]
    ref = dense["block_f32"] @ X
    np.testing.assert_allclose(np.asarray(y16), ref, rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(np.asarray(y32), ref, rtol=1e-5, atol=1e-5)


# --- peak table -------------------------------------------------------------


def test_peak_table_h200():
    from spsparse_tpu.utils.roofline import device_hbm_bandwidth, device_peaks
    p = device_peaks("NVIDIA H200")
    assert (p.hbm_bytes_s, p.bf16_flops, p.tf32_flops, p.f32_flops,
            p.link_bytes_s) == (4.8e12, 989e12, 495e12, 67e12, 450e9)
    assert "700 W" in p.source
    assert device_hbm_bandwidth("NVIDIA H200") == ("NVIDIA H200", 4.8e12)


@pytest.mark.parametrize("kind", ["cpu", "AMD Instinct MI300X",
                                  "NVIDIA A100"])
def test_peak_table_unknown_kind_raises(kind):
    from spsparse_tpu.utils.roofline import device_hbm_bandwidth, device_peaks
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks(kind)
    with pytest.raises(KeyError):
        device_hbm_bandwidth(kind)


def test_peak_table_default_device_is_unknown_here():
    # the test backend is the CPU, which has no entry: no silent default
    from spsparse_tpu.utils.roofline import device_peaks
    with pytest.raises(KeyError):
        device_peaks()


def test_dist_model_defaults_come_from_the_table():
    from spsparse_tpu.dist import model
    from spsparse_tpu.utils.roofline import PEAKS
    h = PEAKS["NVIDIA H200"]
    m = model.RingModel(nnz_local=10, rows_local=10)
    assert m.hbm_gbs == h.hbm_bytes_s / 1e9 == 4800.0
    assert m.link_gbs == h.link_bytes_s / 1e9 == 450.0


# --- compile cache ----------------------------------------------------------


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    from spsparse_tpu.utils.compilecache import cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert cache_dir() == str(tmp_path / "c")


def test_cache_dir_default_is_fixed_in_checkout(monkeypatch):
    import os
    from spsparse_tpu.utils.compilecache import cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = cache_dir()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert d == os.path.join(repo, ".jax_cache")
    assert cache_dir() == d                       # stable across calls


def test_enable_persistent_cache_sets_config_only_without_env(
        monkeypatch, tmp_path):
    from spsparse_tpu.utils import compilecache
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "e"))
    assert compilecache.enable_persistent_cache() == str(tmp_path / "e")
    assert "jax_compilation_cache_dir" not in updates   # JAX reads the env
    assert (tmp_path / "e").is_dir()
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    monkeypatch.setattr(compilecache, "_REPO", str(tmp_path / "repo"))
    path = compilecache.enable_persistent_cache()
    assert path == str(tmp_path / "repo" / ".jax_cache")
    assert updates["jax_compilation_cache_dir"] == path
