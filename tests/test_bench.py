"""bench.py contract: exactly one headline JSON line on stdout."""

import json
import os
import subprocess
import sys


def test_bench_headline_contract(tmp_path):
    detail = tmp_path / "detail.json"
    env = dict(os.environ, SPSPARSE_BENCH_DETAIL=str(detail))
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms','cpu');"
         "import sys; sys.argv=['bench.py','--n','4096'];"
         "exec(open('bench.py').read())"],
        capture_output=True, text=True, timeout=300, cwd=".", env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [l for l in out.stdout.strip().splitlines() if l.strip()]
    assert len(lines) == 1, lines
    payload = json.loads(lines[0])
    assert set(payload) <= {"metric", "value", "unit", "vs_baseline",
                            "over_roofline"}
    assert {"metric", "value", "unit", "vs_baseline"} <= set(payload)
    assert payload["metric"] == "spmv_banded_nnz_per_s"
    assert payload["value"] > 0
    # detail file: full config list with roofline context; the CPU has
    # no published peaks, so no roofline share is claimed there
    doc = json.loads(detail.read_text())
    assert doc["platform"] == "cpu"
    assert payload["vs_baseline"] is None
    assert doc["configs"][0]["metric"] == "spmv_banded_nnz_per_s"
    assert "pct_of_roofline" in doc["configs"][0]["detail"]


def _load_bench_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench_mod", "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_headline_flags_impossible_reading(monkeypatch):
    """A physically impossible headline reading (>105% of roofline) must
    be retried and, if persistent, carried as ``over_roofline`` in the
    headline dict — never published unflagged."""
    bench = _load_bench_module()

    calls = {"n": 0}

    def fake_spmv(n, band):
        calls["n"] += 1
        return {"metric": "spmv_banded_nnz_per_s", "value": 1e12,
                "unit": "nnz/s", "vs_baseline": 2.0,
                "detail": {"pct_of_roofline": 120.0 + calls["n"]}}

    monkeypatch.setattr(bench, "bench_spmv", fake_spmv)
    res = bench.measure_headline(4096, 5, max_retries=2)
    assert calls["n"] == 3  # bounded retries all ran
    assert res["over_roofline"] is True
    assert res["detail"]["over_roofline"] is True
    # best physically-least-impossible attempt is kept (the 121% one)
    assert res["detail"]["pct_of_roofline"] == 121.0
    assert res["detail"]["headline_retries"] == 2


def test_headline_retry_recovers(monkeypatch):
    """A transient spike is retried away: the first physically possible
    reading is published, unflagged."""
    bench = _load_bench_module()
    seq = iter([130.0, 91.0])

    def fake_spmv(n, band):
        return {"metric": "spmv_banded_nnz_per_s", "value": 1e11,
                "unit": "nnz/s", "vs_baseline": 1.3,
                "detail": {"pct_of_roofline": next(seq)}}

    monkeypatch.setattr(bench, "bench_spmv", fake_spmv)
    res = bench.measure_headline(4096, 5, max_retries=2)
    assert "over_roofline" not in res
    assert res["detail"]["pct_of_roofline"] == 91.0
    assert res["detail"]["headline_retries"] == 1


def test_write_detail_all_run_overwrites(tmp_path, monkeypatch):
    """The preserve-richer guard applies only to headline-only runs; an
    --all rerun's incremental writes always land."""
    bench = _load_bench_module()
    out = tmp_path / "d.json"
    monkeypatch.setenv("SPSPARSE_BENCH_DETAIL", str(out))
    rich = [{"config": i} for i in range(5)]
    bench.write_detail(rich)
    # headline-only run with fewer configs: preserved
    bench.write_detail([{"config": 0, "fresh": True}], headline_only=True)
    assert len(json.loads(out.read_text())["configs"]) == 5
    # --all rerun with fewer configs so far: overwrites (incremental)
    bench.write_detail([{"config": 0, "fresh": True}])
    doc = json.loads(out.read_text())
    assert len(doc["configs"]) == 1 and doc["configs"][0]["fresh"]
