"""chip_smoke.py's phase code at tiny sizes on the CPU (kernels in the
Pallas interpreter), and its refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


@pytest.mark.parametrize("name,fn,kw", [
    ("consolidate", cs.phase_consolidate, dict(n_entries=1 << 12)),
    ("banded_spmv", cs.phase_banded_spmv, dict(n=1 << 12)),
    ("banded_spmm", cs.phase_banded_spmm, dict(n=1 << 12)),
    ("block_bf16", cs.phase_block_spmm, dict(m=1 << 9, nrhs=16,
                                             dtype="bfloat16",
                                             interpret=True)),
    ("block_f32", cs.phase_block_spmm, dict(m=1 << 9, nrhs=16,
                                            interpret=True)),
    ("scattered_spmm", cs.phase_scattered_spmm, dict(m=1 << 9, nrhs=16)),
    ("spgemm", cs.phase_spgemm, dict(n_dst=1 << 9, interpret=True)),
    ("cg_f64", cs.phase_cg, dict(grid=24, iters=30)),
    ("gradient", cs.phase_gradient, dict(m=1 << 9, nrhs=16)),
    ("four_cards", cs.phase_four_cards, dict(
        rows_per_card=1 << 10, scattered_rows_per_card=1 << 8)),
])
def test_phase_tiny(name, fn, kw, capsys):
    assert cs.run_phase(name, fn, kw), capsys.readouterr().out
    out = capsys.readouterr().out
    assert out.startswith("phase {") and '"ok": true' in out


def test_four_cards_places_on_four_devices():
    res = cs.phase_four_cards(rows_per_card=1 << 9,
                              scattered_rows_per_card=1 << 7)
    assert res["placed_on_all"] and len(res["devices_used"]) == 4
    assert res["err"] <= res["tol"]


def test_main_refuses_without_gpu(capsys):
    assert cs.main([]) == 2
    out = capsys.readouterr()
    assert out.out == ""                      # no result line
    assert "no GPU" in out.err


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
