"""The command without a card, and without the program beside it, exits
non-zero and prints no result."""
import os
import shutil
import subprocess
import sys
from pathlib import Path


REPO = Path(__file__).resolve().parents[2]


def _run(root: Path, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "sphere_384.static", "--seed", str(2 ** 31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=root, capture_output=True, text=True,
        timeout=300, env=env)


def _no_result(got):
    assert got.returncode != 0
    assert '"correct"' not in got.stdout


def test_no_card():
    got = _run(REPO, {**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    _no_result(got)
    assert got.stderr


def test_no_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    _no_result(_run(tmp_path))
