"""The port's serving soak (zang_tpu_torch/tools/soak.py) and the card's
test files.

- A short soak on the CPU, slow-marked as its twin tests/test_soak.py is:
  clients stream for the whole window (the final quarter too), abrupt churn
  drops do not wedge the server, RSS growth after warmup stays bounded, and
  every lane is freed at the end (~30 s).
- The report's checks on synthetic series: the slope rule (host RSS and
  device memory alike), final-quarter starvation, the churn loop (<1 s).
- tests/test_torch_cuda_{kernels,paths}.py import neither jax nor zang_tpu,
  by their syntax trees and by collecting them without the suite's
  conftest in a process where importing either raises; every case there
  then skips for want of an NVIDIA GPU (~5 s).
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

from zang_tpu_torch.tools import soak

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUDA_FILES = ["tests/test_torch_cuda_kernels.py", "tests/test_torch_cuda_paths.py"]


@pytest.mark.slow
def test_soak_short():
    report = soak.run_soak(seconds=25.0, clients=3, block=1024, key_blocks=16,
                           churn=True, rss_budget_mb=256.0, verbose=False, device="cpu")
    assert report["ok"], report["failures"]
    assert all(b > 0 for b in report["blocks_per_client"]), report
    assert report["stats_acks"] >= 1, report
    # every lane freed once the clients hung up
    assert report["num_clients_at_end"] == 0, report
    assert "device_growth_mb" not in report  # no device memory on the CPU


def test_slope_check():
    flat = [(5.0, 700.0), (10.0, 740.0), (15.0, 741.0), (20.0, 742.0)]
    assert soak.slope_check(flat, 20.0, 64.0) == (740.0, 742.0, 2.0, None)
    # growth before the midpoint is warmup, not a leak
    warm = [(5.0, 100.0), (9.0, 900.0), (10.0, 901.0), (20.0, 930.0)]
    assert soak.slope_check(warm, 20.0, 64.0)[3] is None
    leak = [(5.0, 100.0), (10.0, 110.0), (15.0, 150.0), (20.0, 190.0)]
    post, end, growth, failure = soak.slope_check(leak, 20.0, 64.0, "device memory")
    assert (post, end, growth) == (110.0, 190.0, 80.0)
    assert failure == "device memory grew 80.0 MB after warmup (budget 64.0 MB) — leak-shaped"
    # exactly the budget passes; a run with no sample past the midpoint
    # measures from its first sample
    assert soak.slope_check([(10.0, 1.0), (20.0, 65.0)], 20.0, 64.0)[3] is None
    assert soak.slope_check([(1.0, 1.0), (2.0, 70.0)], 20.0, 64.0)[2] == 69.0


def test_client_failures():
    assert soak.client_failures([(None, 120, 30), (None, 5, 1)]) == []
    assert soak.client_failures([(None, 120, 0), (None, 0, 0), ("EOFError: x", 3, 1)]) == [
        "client 0: starved in the final quarter (120 blocks total)",
        "client 1: received no audio",
        "client 1: starved in the final quarter (0 blocks total)",
        "client 2: EOFError: x"]


def test_churn_failures():
    assert soak.churn_failures(True, 60.0, 4) == []
    assert soak.churn_failures(True, 20.0, 0) == []  # too short to require a drop
    assert soak.churn_failures(False, 60.0, 0) == []
    assert soak.churn_failures(True, 30.0, 0) == ["churn loop never completed a drop cycle"]
    assert soak.churn_failures(True, 60.0, 2, "OSError: y") == ["churn: OSError: y"]


def test_soak_without_cuda_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert soak.main(["--seconds", "1"]) == 1
    assert "is_available() is False" in capsys.readouterr().err


def _imported_roots(path):
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0]


def test_cuda_test_files_import_no_jax_package():
    for path in CUDA_FILES:
        roots = set(_imported_roots(path))
        assert "zang_tpu_torch" in roots and "torch" in roots, path
        assert not roots & {"jax", "jaxlib", "zang_tpu"}, (path, roots)


def test_cuda_test_files_collect_without_jax():
    """The card's command, in a process where jax and zang_tpu cannot be
    imported: every case collects and skips for want of a GPU."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'zang_tpu'):\n"
            "    sys.modules[m] = None  # importing it raises ImportError\n"
            "import pytest\n"
            "sys.exit(pytest.main(sys.argv[1:]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-c", code, "--noconftest", "-p", "no:cacheprovider",
         "-p", "no:xdist", "-p", "no:randomly", "-m", "cuda", "-rs", "-q", *CUDA_FILES],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    out = proc.stdout
    assert proc.returncode == 0, out[-3000:]
    summary = out.strip().splitlines()[-1]
    assert summary.startswith("112 skipped") and "error" not in summary, summary
    reasons = [ln for ln in out.splitlines() if ln.startswith("SKIPPED")]
    assert reasons and all("needs an NVIDIA GPU" in ln for ln in reasons), reasons
