"""CLI fidelity oracle: CSV output must match the independent NumPy pipeline
line for line, including Swift-style float formatting and debounce."""

from conftest import SAMPLE_TXT
import numpy as np
import pytest

import reference_impl as ref
from syllable_detector_tpu.cli import main as cli_main
from syllable_detector_tpu.runtime.track_detector import TrackDetector
from syllable_detector_tpu.utils.fmt import fmt_double, fmt_float32
from syllable_detector_tpu.utils.wav import read_wav, write_wav
from test_detector import make_audio


def assert_csv_close(got, want, rtol=1e-4, atol=1e-5):
    """Detection lines must agree exactly on channel/sample/time and within
    float tolerance on the network outputs (the BASELINE.json contract)."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        gp, wp = g.split(","), w.split(",")
        assert gp[:3] == wp[:3], (g, w)
        np.testing.assert_allclose(
            [float(v) for v in gp[3:]],
            [float(v) for v in wp[3:]],
            rtol=rtol,
            atol=atol,
        )


@pytest.fixture(scope="module")
def audio(tmp_path_factory):
    rng = np.random.default_rng(7)
    x = make_audio(rng, seconds=1.2)
    path = tmp_path_factory.mktemp("wav") / "test.wav"
    write_wav(path, x, 44100, dtype="float32")
    return str(path), x


def test_wav_roundtrip(tmp_path, rng):
    x = (rng.standard_normal(1000) * 0.3).astype(np.float32)
    p = tmp_path / "f32.wav"
    write_wav(p, x, 44100, dtype="float32")
    y, rate = read_wav(p)
    assert rate == 44100 and y.shape == (1000, 1)
    np.testing.assert_array_equal(y[:, 0], x)

    p16 = tmp_path / "i16.wav"
    write_wav(p16, x, 22050, dtype="int16")
    y16, rate16 = read_wav(p16)
    assert rate16 == 22050
    np.testing.assert_allclose(
        y16[:, 0], np.clip(x, -1.0, 32767.0 / 32768.0), atol=1.0 / 32768
    )


def test_read_audio_aiff_and_au(tmp_path, rng):
    """Non-WAV ingest (the reference CLI decodes anything AVFoundation can
    read, main.swift:63-76): AIFF and Sun AU via read_audio's magic sniff."""
    import warnings

    from syllable_detector_tpu.utils.wav import read_audio

    x = (rng.standard_normal((500, 2)) * 0.3).astype(np.float32)
    pcm = np.clip(x * 32768.0, -32768, 32767).astype(">i2")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import aifc
        import sunau

    p_aiff = tmp_path / "a.aiff"
    f = aifc.open(str(p_aiff), "wb")
    f.setnchannels(2)
    f.setsampwidth(2)
    f.setframerate(22050)
    f.writeframes(pcm.tobytes())
    f.close()
    y, rate = read_audio(p_aiff)
    assert rate == 22050 and y.shape == (500, 2)
    np.testing.assert_allclose(y, pcm.astype(np.float32) / 32768.0, atol=1e-7)

    p_au = tmp_path / "a.au"
    f = sunau.open(str(p_au), "wb")
    f.setnchannels(1)
    f.setsampwidth(2)
    f.setframerate(8000)
    f.setcomptype("NONE", "")  # linear PCM (sunau defaults to ULAW)
    # sunau writes linear frames VERBATIM (no byteswap — CPython
    # writeframesraw), so spec-compliant AU data must be fed big-endian
    f.writeframes(pcm[:, 0].tobytes())
    f.close()
    y, rate = read_audio(p_au)
    assert rate == 8000 and y.shape == (500, 1)
    np.testing.assert_allclose(
        y[:, 0], pcm[:, 0].astype(np.float32) / 32768.0, atol=1e-7
    )

    # ULAW AU: sunau decodes via audioop to NATIVE-endian int16; lossy codec
    p_ul = tmp_path / "u.au"
    f = sunau.open(str(p_ul), "wb")
    f.setnchannels(1)
    f.setsampwidth(2)
    f.setframerate(8000)
    f.setcomptype("ULAW", "")
    f.writeframes(pcm[:, 0].astype("=i2").tobytes())  # lin2ulaw wants native
    f.close()
    y, rate = read_audio(p_ul)
    assert rate == 8000 and y.shape == (500, 1)
    np.testing.assert_allclose(
        y[:, 0], pcm[:, 0].astype(np.float32) / 32768.0, atol=0.02
    )

    # WAV still routes through the native parser
    p_wav = tmp_path / "a.wav"
    write_wav(p_wav, x, 44100, dtype="float32")
    y, rate = read_audio(p_wav)
    assert rate == 44100 and y.shape == (500, 2)

    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"\x00\x01\x02\x03garbage")
    with pytest.raises(ValueError, match="unsupported audio container"):
        read_audio(bad)


def test_cli_detects_on_aiff(sample_config, tmp_path, capsys):
    """End-to-end: AIFF corpus file through the detection CLI."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import aifc

    rng = np.random.default_rng(7)
    x = make_audio(rng, seconds=0.4)
    pcm = np.clip(x * 32768.0, -32768, 32767).astype(">i2")
    p = tmp_path / "c.aiff"
    f = aifc.open(str(p), "wb")
    f.setnchannels(1)
    f.setsampwidth(2)
    f.setframerate(44100)
    f.writeframes(pcm.tobytes())
    f.close()
    rc = cli_main(["-n", SAMPLE_TXT, "-a", str(p)])
    assert rc == 0
    out = [l for l in capsys.readouterr().out.splitlines() if l]
    want = ref.cli_lines(sample_config, pcm.astype(np.float32) / 32768.0)
    assert len(want) > 0
    assert_csv_close(out, want)


def test_fmt_matches_swift_style():
    assert fmt_double(36.1292063492063) == "36.1292063492063"
    assert fmt_double(1.0) == "1.0"
    assert fmt_float32(np.float32(0.918557)) == "0.918557"
    assert fmt_float32(np.float32(1.0)) == "1.0"


def test_track_detector_matches_oracle(sample_config, audio):
    path, x = audio
    lines = []
    td = TrackDetector(sample_config, channel=0, emit=lines.append)
    for start in range(0, len(x), 8192):  # AVFoundation-sized buffers
        td.process(x[start : start + 8192])

    want = ref.cli_lines(sample_config, x)
    assert len(want) > 0, "fixture audio must produce detections"
    assert_csv_close(lines, want)


def test_debounce(sample_config, audio):
    path, x = audio
    lines = []
    td = TrackDetector(sample_config, channel=0, emit=lines.append)
    td.debounce_time = 0.25
    td.process(x)
    want = ref.cli_lines(
        sample_config, x, debounce_frames=int(0.25 * 44100)
    )
    assert_csv_close(lines, want)
    assert len(lines) < len(ref.cli_lines(sample_config, x))


def test_cli_end_to_end(sample_config, audio, capsys):
    path, x = audio
    rc = cli_main(["-n", SAMPLE_TXT, "-a", path])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert_csv_close(out, ref.cli_lines(sample_config, x))


def test_cli_multifile_header(sample_config, audio, capsys, tmp_path):
    path, x = audio
    rc = cli_main(["-n", SAMPLE_TXT, "-a", path, "-a", path])
    out = capsys.readouterr().out.strip().splitlines()
    # path printed before each file's events (main.swift:122-124)
    assert out[0] == path
    assert out.count(path) == 2


def test_cli_bad_audio(capsys, tmp_path):
    missing = str(tmp_path / "nope.wav")
    rc = cli_main(["-n", SAMPLE_TXT, "-a", missing])
    assert rc == 0  # reference continues past unreadable files
    assert "Unable to read" in capsys.readouterr().err


def test_cli_bad_net(capsys, tmp_path):
    rc = cli_main(["-n", str(tmp_path / "nope.txt"), "-a", "x.wav"])
    assert rc == 1
    assert "Unable to load the network configuration" in capsys.readouterr().err


def test_cli_resamples_mismatched_rate(sample_config, tmp_path, capsys):
    """A 22.05k file is polyphase-resampled to the 44.1k network rate, like
    the reference's AVAssetReader output settings."""
    rng = np.random.default_rng(3)
    n = int(1.2 * 22050)
    t = np.arange(n) / 22050.0
    phase = 2 * np.pi * np.cumsum(np.linspace(2000.0, 7000.0, n)) / 22050.0
    x = (0.5 * np.sin(phase) * (0.3 + 0.7 * (np.sin(2 * np.pi * 3 * t) > 0)))
    p = tmp_path / "lowrate.wav"
    write_wav(p, x.astype(np.float32), 22050, dtype="float32")
    rc = cli_main(["-n", SAMPLE_TXT, "-a", str(p)])
    captured = capsys.readouterr()
    assert rc == 0
    assert "Resampling" in captured.err
    lines = [l for l in captured.out.splitlines() if l]
    # resampled audio still sweeps the band -> detections fire
    assert len(lines) > 0
    # --no-resample keeps raw samples (chirp then only sweeps to 3.5kHz at
    # the wrong rate; behavior differs)
    rc = cli_main(
        ["-n", SAMPLE_TXT, "-a", str(p), "--no-resample"]
    )
    assert "Warning" in capsys.readouterr().err


def test_inspect(capsys):
    from syllable_detector_tpu.inspect_net import main as inspect_main

    rc = inspect_main(["-n", SAMPLE_TXT])
    out = capsys.readouterr().out
    assert rc == 0
    assert "hop:                132 samples" in out
    assert "bins [12, 41) = 29 bins" in out
    assert "290x4 TanSig -> 4x1 PureLin" in out
    assert "foldable chain:     True" in out
    assert inspect_main(["-n", "/nonexistent.txt"]) == 1


def test_module_dispatcher(capsys):
    from syllable_detector_tpu.__main__ import main as dispatch

    assert dispatch([]) == 2
    assert "detect" in capsys.readouterr().out
    assert dispatch(["inspect", "-n", SAMPLE_TXT]) == 0
    assert "foldable chain" in capsys.readouterr().out


def test_rfft_method_unbatched(sample_config, tmp_path, capsys):
    """--method rfft runs the sequential (per-track streaming) path on the
    full-FFT spectral backend and must match the oracle."""
    import reference_impl as ref
    from syllable_detector_tpu.utils.wav import write_wav
    from test_detector import make_audio

    rng = np.random.default_rng(21)
    x = make_audio(rng, seconds=0.4)
    p = tmp_path / "f.wav"
    write_wav(p, x, 44100, dtype="float32")
    rc = cli_main(
        ["-n", SAMPLE_TXT, "-a", str(p), "--method", "rfft"]
    )
    assert rc == 0
    out = [l for l in capsys.readouterr().out.splitlines() if l]
    want = ref.cli_lines(sample_config, x)
    assert len(want) > 0
    assert_csv_close(out, want)


def test_read_audio_decode_errors_are_valueerror(tmp_path):
    # decode failures must keep the documented ValueError contract so the
    # per-file skip-and-continue paths (cli/corpus/monitor) survive bad files
    from syllable_detector_tpu.utils.wav import read_audio

    p = tmp_path / "truncated.aiff"
    p.write_bytes(b"FORM\x00\x00\x00\x08AIFF")  # header, no chunks
    with pytest.raises(ValueError, match="decode failed"):
        read_audio(p)

    q = tmp_path / "truncated.au"
    q.write_bytes(b".snd\x00\x00\x00\x18")  # header cut short
    with pytest.raises(ValueError, match="decode failed|unsupported"):
        read_audio(q)


def test_cli_multi_net_geometry_mismatch(sample_config, tmp_path, capsys):
    """Repeatable -n with a geometry-mismatched second net fails fast with
    a clean stderr message on BOTH the sequential and batched paths."""
    import dataclasses

    from syllable_detector_tpu.config.model_format import dumps_config

    other = dataclasses.replace(sample_config, scaling="log")
    p_net = tmp_path / "other.txt"
    p_net.write_text(dumps_config(other))
    wav = tmp_path / "x.wav"
    rng = np.random.default_rng(9)
    write_wav(wav, make_audio(rng, seconds=0.2), 44100, dtype="float32")

    for extra in ([], ["--batched"]):
        rc = cli_main(
            ["-n", SAMPLE_TXT, "-n", str(p_net),
             "-a", str(wav)] + extra
        )
        assert rc == 1
        err = capsys.readouterr().err
        assert "geometry" in err
