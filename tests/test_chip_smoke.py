"""Rehearsal of ``chip_smoke.py`` on the CPU at tiny sizes.

The phase functions are importable and take their sizes as arguments;
here they run on CPU devices (the kernel in interpret mode) to check
control flow and gates.  ``main()`` itself must refuse to run without a
GPU, and the script must fail outside a checkout of the repository.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from se3_icp.utils.config import GOLDEN  # noqa: E402

CFG = GOLDEN.replace(number_of_nn_for_lrf=30, normals_knn=10)


@pytest.fixture(scope="module")
def tiny():
    return cs.golden_pairs(2, points=400)


def _run(args, cwd, extra_env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(extra_env or {}))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _has_result(stdout):
    for ln in stdout.splitlines():
        try:
            if json.loads(ln).get("ok"):
                return True
        except (ValueError, AttributeError):
            continue
    return False


def test_refuses_without_gpu():
    out = _run(["chip_smoke.py"], REPO)
    assert out.returncode != 0
    assert not _has_result(out.stdout)
    assert "no GPU" in out.stdout


def test_fails_outside_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py"], tmp_path,
               {"PYTHONPATH": "", "PYTHONSAFEPATH": "1"})
    assert out.returncode != 0
    assert not _has_result(out.stdout)


def test_card_line_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    line = cs.card_line()
    assert isinstance(line, str) and line


def test_phase_compile(tiny, capsys):
    pairs, _ = tiny
    cs.phase_compile(pairs, CFG)
    out = capsys.readouterr().out
    assert "compile: batch 2 se3_pt2pl, bucket 512" in out
    assert "temp_size_in_bytes=" in out


def test_phase_golden(tiny, capsys):
    pairs, T = tiny
    cs.phase_golden(pairs, T, CFG, n_ref=1, reps=1, card="cpu rehearsal")
    out = capsys.readouterr().out
    assert "golden: 2 pairs pass" in out
    assert "vs numpy reference" in out and "pairs/s" in out


def test_phase_golden_gate_fails_on_wrong_truth(tiny):
    pairs, T = tiny
    wrong = T.copy()
    wrong[:3, 3] += 1.0
    with pytest.raises(AssertionError, match="failed gate"):
        cs.phase_golden(pairs, wrong, CFG, n_ref=0, reps=1)


def test_phase_variants(tiny, capsys):
    pairs, T = tiny
    cases = cs.variant_cases(pairs, T, CFG)
    assert [c[0] for c in cases] == list(cs.VARIANTS) + [
        "se3_pt2pl overlap 0.75"]
    cs.phase_variants([c for c in cases if c[2] in ("se3_pt2pt",
                                                    "se3_gicp")])
    assert capsys.readouterr().out.count("pairs pass") == 2


def test_phase_kernel_interpret(tiny, capsys):
    pairs, _ = tiny
    cs.phase_kernel(shapes=((2, 300, 12), (1, 200, 3)), reps=1,
                    ab_pairs=pairs, ab_cfg=CFG, interpret=True)
    out = capsys.readouterr().out
    assert out.count("float64 check ok") == 2
    assert "program A/B (A B B A" in out


def test_nn_oracle_check_rejects_wrong_match():
    q, t, nv = cs.kernel_inputs(1, 64, 3)
    idx = np.zeros((1, 64), np.int64)
    with pytest.raises(AssertionError, match="beyond tol"):
        cs.nn_oracle_check(q, t, nv, idx, "wrong")


def test_four_cards_on_virtual_devices(tiny, capsys):
    """The --four-cards path on 4 of the harness's virtual CPU devices."""
    pairs, _ = tiny
    cs.four_cards(pairs * 2, CFG, jax.devices())
    out = capsys.readouterr().out
    assert "pair-DP 4 pairs over 4 cards" in out
    assert "2-D mesh" in out


def test_phase_tests_skip_cleanly_off_gpu():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; chip_smoke.phase_tests()")
    out = _run(["-c", code, REPO], REPO)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "tests: gpu_tests passed" in out.stdout
