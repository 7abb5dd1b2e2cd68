"""Multi-process corpus scan: jax.distributed over two local CPU processes
(SURVEY §5 distributed backend: process-sharded file lists)."""

from conftest import SAMPLE_TXT
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import reference_impl as ref
from syllable_detector_tpu.dist_scan import shard_paths
from syllable_detector_tpu.utils.wav import write_wav
from test_cli_golden import assert_csv_close
from test_detector import make_audio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_shard_paths_partition():
    paths = [f"f{i}" for i in range(7)]
    shards = [shard_paths(paths, i, 3) for i in range(3)]
    # complete, disjoint, order-preserving, contiguous
    assert sum(shards, []) == paths
    assert shard_paths(paths, 0, 1) == paths
    assert shard_paths([], 1, 2) == []
    # more processes than files: some shards empty, none lost
    shards = [shard_paths(paths[:2], i, 4) for i in range(4)]
    assert sum(shards, []) == paths[:2]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_scan(sample_config, tmp_path):
    rng = np.random.default_rng(5)
    paths = []
    audios = []
    for i in range(3):
        x = make_audio(rng, seconds=0.4)
        p = tmp_path / f"c{i}.wav"
        write_wav(p, x, 44100, dtype="float32")
        paths.append(str(p))
        audios.append(x)

    out_dir = tmp_path / "out"
    port = _free_port()
    procs = []
    for pid in range(2):
        cmd = [
            sys.executable, "-m", "syllable_detector_tpu.dist_scan",
            "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", "2", "--process-id", str(pid),
            "--platform", "cpu",
            "-n", SAMPLE_TXT,
            "-o", str(out_dir),
        ]
        for p in paths:
            cmd += ["-a", p]
        procs.append(
            subprocess.Popen(
                cmd, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
            )
        )
    outs = [p.communicate(timeout=150) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"rc={p.returncode}\n{se[-2000:]}"

    # every process reports the same psum'd global detection count
    globals_ = [
        l.split("(global ")[1].rstrip(")")
        for _, se in outs
        for l in se.splitlines()
        if "(global " in l
    ]
    assert len(globals_) == 2 and globals_[0] == globals_[1]

    merged = (out_dir / "merged.csv").read_text().splitlines()
    # merged output = the single-process CLI contract, file order preserved
    assert merged[0] == paths[0]
    idx = [merged.index(p) for p in paths]
    assert idx == sorted(idx)
    for k, p in enumerate(paths):
        lo = idx[k] + 1
        hi = idx[k + 1] if k + 1 < len(paths) else len(merged)
        assert_csv_close(merged[lo:hi], ref.cli_lines(sample_config, audios[k]))
