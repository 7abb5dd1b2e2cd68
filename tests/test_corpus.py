"""Batched corpus scan must equal the streaming CLI path file for file."""

from conftest import SAMPLE_TXT
import numpy as np

import reference_impl as ref
from syllable_detector_tpu.corpus import (
    corpus_csv_lines,
    scan_corpus,
    scan_corpus_files,
)
from syllable_detector_tpu.utils.wav import write_wav
from test_cli_golden import assert_csv_close
from test_detector import make_audio


def test_scan_corpus_matches_oracle(sample_config):
    rng = np.random.default_rng(9)
    streams = [
        make_audio(rng, seconds=0.4),
        make_audio(rng, seconds=0.7),
        make_audio(rng, seconds=0.25),
    ]
    results = scan_corpus(sample_config, streams)
    assert len(results) == 3
    for s, outs in zip(streams, results):
        want = ref.detect_offline(sample_config, s)
        assert outs.shape == want.shape
        np.testing.assert_allclose(outs, want, rtol=1e-3, atol=2e-4)


def test_corpus_csv_matches_oracle(sample_config):
    rng = np.random.default_rng(9)
    s = make_audio(rng, seconds=0.8)
    outs = scan_corpus(sample_config, [s])[0]
    lines = corpus_csv_lines(sample_config, outs)
    want = ref.cli_lines(sample_config, s)
    assert len(want) > 0
    assert_csv_close(lines, want)


def test_scan_corpus_files(sample_config, tmp_path):
    rng = np.random.default_rng(9)
    paths = []
    audios = []
    for i in range(2):
        x = make_audio(rng, seconds=0.5)
        p = tmp_path / f"f{i}.wav"
        write_wav(p, x, 44100, dtype="float32")
        paths.append(str(p))
        audios.append(x)
    lines = []
    scan_corpus_files(sample_config, paths + [str(tmp_path / "missing.wav")],
                      emit=lines.append, err=lambda s: None)
    # multi-file headers present
    assert lines[0] == paths[0]
    assert paths[1] in lines
    # events match the per-file oracle
    i1 = lines.index(paths[1])
    assert_csv_close(lines[1:i1], ref.cli_lines(sample_config, audios[0]))
    assert_csv_close(lines[i1 + 1 :], ref.cli_lines(sample_config, audios[1]))


def test_scan_corpus_empty(sample_config):
    assert scan_corpus(sample_config, []) == []


def test_scan_corpus_mesh_sharded(sample_config):
    """Lanes sharded across the 8-device test mesh (with padding to a
    multiple of the mesh size) must equal the single-device scan."""
    from syllable_detector_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(17)
    streams = [make_audio(rng, seconds=0.3) for _ in range(5)]  # 5 % 8 != 0
    mesh = make_mesh()
    got = scan_corpus(sample_config, streams, mesh=mesh)
    want = scan_corpus(sample_config, streams)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def test_cli_batched_mesh(sample_config, tmp_path, capsys):
    from syllable_detector_tpu.cli import main as cli_main

    rng = np.random.default_rng(18)
    x = make_audio(rng, seconds=0.4)
    p = tmp_path / "m.wav"
    write_wav(p, x, 44100, dtype="float32")
    rc = cli_main(
        ["-n", SAMPLE_TXT, "-a", str(p), "--batched", "--mesh"]
    )
    assert rc == 0
    out = [l for l in capsys.readouterr().out.splitlines() if l]
    assert_csv_close(out, ref.cli_lines(sample_config, x))


def test_scan_corpus_rfft_method(sample_config):
    """The rfft spectral backend through the batched corpus scan agrees
    with the GEMM band DFT."""
    rng = np.random.default_rng(13)
    streams = [make_audio(rng, seconds=0.3), make_audio(rng, seconds=0.3)]
    got = scan_corpus(sample_config, streams, method="rfft")
    want = scan_corpus(sample_config, streams, method="matmul")
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=2e-4)


def test_scan_corpus_files_multichannel(sample_config, tmp_path):
    """Batched mode runs every channel of a file, like the reference CLI's
    one-TrackDetector-per-track loop (ADVICE r1: channel-0-only bug)."""
    rng = np.random.default_rng(11)
    ch0 = make_audio(rng, seconds=0.5)
    ch1 = make_audio(rng, seconds=0.5)
    p = tmp_path / "stereo.wav"
    write_wav(p, np.stack([ch0, ch1], axis=1), 44100, dtype="float32")
    lines = []
    scan_corpus_files(sample_config, [str(p)], emit=lines.append,
                      err=lambda s: None)
    got0 = [l for l in lines if l.startswith("0,")]
    got1 = [l for l in lines if l.startswith("1,")]
    assert len(got0) + len(got1) == len(lines)
    assert_csv_close(got0, ref.cli_lines(sample_config, ch0, channel=0))
    assert_csv_close(got1, ref.cli_lines(sample_config, ch1, channel=1))
    assert got1, "channel 1 produced no detections; fixture too weak"


def test_cli_batched_mode(sample_config, tmp_path, capsys):
    from syllable_detector_tpu.cli import main as cli_main

    rng = np.random.default_rng(9)
    paths = []
    audios = []
    for i in range(2):
        x = make_audio(rng, seconds=0.4)
        p = tmp_path / f"b{i}.wav"
        write_wav(p, x, 44100, dtype="float32")
        paths.append(str(p))
        audios.append(x)
    rc = cli_main(
        ["-n", SAMPLE_TXT, "-a", paths[0], "-a", paths[1],
         "--batched"]
    )
    assert rc == 0
    out = [l for l in capsys.readouterr().out.splitlines() if l]
    assert out[0] == paths[0]
    i1 = out.index(paths[1])
    assert_csv_close(out[1:i1], ref.cli_lines(sample_config, audios[0]))
    assert_csv_close(out[i1 + 1 :], ref.cli_lines(sample_config, audios[1]))


def test_batched_resamples_mismatched_rate(sample_config, tmp_path):
    """BASELINE config 4: mismatched-rate files polyphase-resample into the
    batched detection path."""
    rng = np.random.default_rng(4)
    n = int(1.0 * 88200)
    phase = 2 * np.pi * np.cumsum(np.linspace(2000.0, 7000.0, n)) / 88200.0
    x = (0.5 * np.sin(phase) + 0.01 * rng.standard_normal(n)).astype(np.float32)
    p = tmp_path / "hi.wav"
    write_wav(p, x, 88200, dtype="float32")
    lines = []
    errs = []
    scan_corpus_files(sample_config, [str(p)], emit=lines.append, err=errs.append)
    assert any("Resampling" in e for e in errs)
    assert len(lines) > 0  # the band sweep survives 2x downsampling


def test_scan_corpus_files_grouped_matches_ungrouped(sample_config, tmp_path):
    """group_files chunking must preserve the exact CSV contract and order
    (file-major, headers on every file)."""
    from syllable_detector_tpu.corpus import scan_corpus_files
    from syllable_detector_tpu.utils.wav import write_wav

    rng = np.random.default_rng(21)
    paths = []
    for i in range(5):
        x = make_audio(rng, seconds=0.3)
        p = tmp_path / f"f{i}.wav"
        write_wav(p, x, 44100, dtype="float32")
        paths.append(str(p))

    def run(**kw):
        lines = []
        scan_corpus_files(
            sample_config, paths, emit=lines.append, err=lambda s: None, **kw
        )
        return lines

    assert run(group_files=2) == run()
    assert run(group_files=1) == run()


def test_scan_grouped_mesh_fused_combination(sample_config, tmp_path):
    """All batched options together (mesh sharding + file groups + rfft
    kernel) must still match the plain scan."""
    from syllable_detector_tpu.corpus import scan_corpus_files
    from syllable_detector_tpu.parallel.mesh import make_mesh
    from syllable_detector_tpu.utils.wav import write_wav

    rng = np.random.default_rng(31)
    paths = []
    for i in range(3):
        x = make_audio(rng, seconds=0.25)
        p = tmp_path / f"g{i}.wav"
        write_wav(p, x, 44100, dtype="float32")
        paths.append(str(p))

    def run(**kw):
        lines = []
        scan_corpus_files(
            sample_config, paths, emit=lines.append, err=lambda s: None, **kw
        )
        return lines

    plain = run()
    combo = run(mesh=make_mesh(8), group_files=2, method="rfft")
    assert len(combo) == len(plain)
    # float formatting may differ in the last ulp between kernels; compare
    # the sample-accounting columns exactly and outputs numerically
    for a, b in zip(plain, combo):
        if "," not in a:
            assert a == b
            continue
        ca, cb = a.split(","), b.split(",")
        assert ca[:2] == cb[:2]
        np.testing.assert_allclose(
            [float(v) for v in ca[2:]], [float(v) for v in cb[2:]],
            rtol=1e-3, atol=1e-3,
        )


# ---------------------------------------------------------------------------
# distinct per-lane networks (one net per channel, Processor.swift:57-59)
# ---------------------------------------------------------------------------


def _perturbed_cfg(cfg, seed, threshold_scale=0.9):
    import copy

    c2 = copy.deepcopy(cfg)
    r = np.random.default_rng(seed)
    for l in c2.layers:
        l.weights = (
            l.weights * (1.0 + 0.05 * r.standard_normal(l.weights.shape))
        ).astype(np.float32)
    c2.thresholds = [t * threshold_scale for t in cfg.thresholds]
    return c2


def test_scan_corpus_distinct_lane_nets(sample_config):
    import pytest

    rng = np.random.default_rng(21)
    streams = [make_audio(rng, seconds=0.4) for _ in range(3)]
    cfg2 = _perturbed_cfg(sample_config, 1)
    lane_cfgs = [sample_config, cfg2, sample_config]
    for method in ("matmul", "rfft"):
        results = scan_corpus(
            sample_config, streams, method=method, lane_configs=lane_cfgs
        )
        for s, c, outs in zip(streams, lane_cfgs, results):
            want = ref.detect_offline(c, s)
            np.testing.assert_allclose(outs, want, rtol=1e-3, atol=2e-4)
    # lane 1's outputs genuinely came from the distinct net
    assert np.abs(results[0][: len(results[1])] - results[1]).max() > 0


def test_scan_corpus_distinct_geometry_mismatch(sample_config):
    import dataclasses

    import pytest

    rng = np.random.default_rng(22)
    streams = [make_audio(rng, seconds=0.3)] * 2
    bad = dataclasses.replace(sample_config, scaling="log")
    with pytest.raises(ValueError, match="geometry"):
        scan_corpus(
            sample_config, streams, lane_configs=[sample_config, bad]
        )


def test_scan_corpus_files_multi_net(sample_config, tmp_path):
    """A stereo file with nets cycled per channel: each channel's events
    must match the single-net oracle for ITS network (including its own
    thresholds)."""
    rng = np.random.default_rng(23)
    left = make_audio(rng, seconds=0.5)
    right = make_audio(rng, seconds=0.5)
    p = tmp_path / "stereo.wav"
    write_wav(p, np.stack([left, right], axis=1), 44100, dtype="float32")
    cfg2 = _perturbed_cfg(sample_config, 2)

    for method in ("matmul", "rfft"):
        lines = []
        scan_corpus_files(
            [sample_config, cfg2], [str(p)], emit=lines.append,
            err=lambda s: None, method=method,
        )
        ch0 = [l for l in lines if l.startswith("0,")]
        ch1 = [l for l in lines if l.startswith("1,")]
        want0 = ref.cli_lines(sample_config, left)
        want1 = [
            l.replace("0,", "1,", 1) for l in ref.cli_lines(cfg2, right)
        ]
        assert_csv_close(ch0, want0)
        assert_csv_close(ch1, want1)


def test_scan_corpus_distinct_mesh(sample_config):
    """Distinct lane nets + mesh sharding with lane padding to the mesh
    size."""
    from syllable_detector_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(24)
    streams = [make_audio(rng, seconds=0.3) for _ in range(3)]  # pads to 4
    cfg2 = _perturbed_cfg(sample_config, 3)
    lane_cfgs = [sample_config, cfg2, cfg2]
    mesh = make_mesh(4)
    for method in ("matmul", "rfft"):
        results = scan_corpus(
            sample_config, streams, method=method, mesh=mesh,
            lane_configs=lane_cfgs,
        )
        for s, c, outs in zip(streams, lane_cfgs, results):
            want = ref.detect_offline(c, s)
            np.testing.assert_allclose(outs, want, rtol=1e-3, atol=2e-4)
