"""bench.py and chip_smoke.py contracts off the card: both refuse to run
without a GPU (they never report CPU numbers), chip_smoke.py fails on its
own outside the repo, and its CPU rehearsal drives every phase."""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def test_bench_refuses_cpu(capsys):
    import bench

    assert bench.main() == 1
    captured = capsys.readouterr()
    assert "needs an NVIDIA GPU" in captured.err
    assert captured.out == ""


def test_chip_smoke_refuses_cpu(capsys):
    import chip_smoke

    assert chip_smoke.main([]) == 2
    captured = capsys.readouterr()
    assert "needs an NVIDIA GPU" in captured.err
    assert '"ok"' not in captured.out


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_rehearsal(capsys):
    """Every phase at tiny sizes on the CPU; the last line is the result."""
    import chip_smoke

    assert chip_smoke.main(["--rehearse"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {
        "ok": True, "device": {"platform": "cpu", "kind": "cpu", "count": 8},
    }
