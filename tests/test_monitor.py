"""End-to-end monitor CLI: the headless equivalent of the reference GUI's
processor window (channel table at 10 Hz + TTL outputs,
ViewControllerProcessor.swift:57, 110-154, 278-284)."""

from conftest import SAMPLE_TXT
import numpy as np
import pytest

from syllable_detector_tpu.monitor import main as monitor_main
from syllable_detector_tpu.utils.wav import write_wav

NET = SAMPLE_TXT


@pytest.fixture(scope="module")
def chirp_wav(tmp_path_factory):
    """2-7 kHz gated chirp that trips the sample net."""
    rate = 44100
    n = int(1.0 * rate)
    rng = np.random.default_rng(3)
    phase = 2 * np.pi * np.cumsum(np.linspace(2000.0, 7000.0, n)) / rate
    t = np.arange(n) / rate
    x = 0.5 * np.sin(phase) + 0.02 * rng.standard_normal(n)
    x = (x * (0.3 + 0.7 * (np.sin(2 * np.pi * 3.0 * t) > 0))).astype(np.float32)
    p = tmp_path_factory.mktemp("monitor") / "chirp.wav"
    write_wav(p, x, rate, dtype="float32")
    return str(p)


def test_monitor_audio_output(chirp_wav, capsys):
    rc = monitor_main(
        ["-n", NET, "-a", chirp_wav, "--channels", "2", "--duration", "1.0"]
    )
    assert rc == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    # channel table with header and per-channel level rows
    assert lines[0].split() == [
        "chan", "in", "RMS", "max", "out", "age", "s", "lost",
    ]
    rows0 = [l for l in lines if l.strip().startswith("0 ")]
    rows1 = [l for l in lines if l.strip().startswith("1 ")]
    assert rows0 and rows1
    # levels become non-zero once audio flows (RMS col), like the GUI meters
    assert any(float(r.split()[1]) > 0 for r in rows0)
    # the age column updates once capture delivers ('-' only before then):
    # the final table (after the stream ended) must show a numeric age
    assert float(rows0[-1].split()[3]) >= 0.0
    # the chirp trips the detector on both channels and fires TTL events
    det_line = next(l for l in lines if l.startswith("detections per channel"))
    dets = eval(det_line.split(":", 1)[1])
    assert len(dets) == 2 and all(d > 0 for d in dets)
    ttl_line = next(l for l in lines if l.startswith("TTL events"))
    assert int(ttl_line.split(":", 1)[1]) > 0


def test_monitor_event_log(chirp_wav, capsys, tmp_path):
    """--event-log leaves the offline CLI's CSV record for the live
    session: one row per detection, sample indices on the hop grid
    starting at the warm-up boundary, seconds = sample/rate."""
    log_path = tmp_path / "events.csv"
    rc = monitor_main(
        ["-n", NET, "-a", chirp_wav, "--channels", "2",
         "--duration", "1.0", "--event-log", str(log_path)]
    )
    assert rc == 0
    out = capsys.readouterr().out
    det_line = next(
        l for l in out.splitlines() if l.startswith("detections per channel")
    )
    dets = eval(det_line.split(":", 1)[1])

    from syllable_detector_tpu.config.model_format import load_config

    cfg = load_config(NET)
    hop = cfg.window_length - cfg.window_overlap
    first = cfg.window_length + hop * (cfg.time_range - 1)
    rows = log_path.read_text().strip().splitlines()
    assert len(rows) == sum(dets)  # one CSV row per counted detection
    by_ch = {0: 0, 1: 0}
    for r in rows:
        parts = r.split(",")
        ch, sample, seconds = int(parts[0]), int(parts[1]), float(parts[2])
        outputs = [float(v) for v in parts[3:]]
        by_ch[ch] += 1
        assert (sample - first) % hop == 0 and sample >= first
        assert abs(seconds - sample / cfg.sampling_rate) < 1e-9
        assert len(outputs) == 1 and outputs[0] >= cfg.thresholds[0]
    assert by_ch[0] == dets[0] and by_ch[1] == dets[1]

    # batched-drain mode leaves the identical record (same clock)
    log2 = tmp_path / "events2.csv"
    rc = monitor_main(
        ["-n", NET, "-a", chirp_wav, "--channels", "2", "--duration", "1.0",
         "--batched-drain", "--event-log", str(log2)]
    )
    assert rc == 0
    rows2 = log2.read_text().strip().splitlines()
    key = lambda r: (int(r.split(",")[0]), int(r.split(",")[1]))
    assert sorted(map(key, rows2)) == sorted(map(key, rows))


def test_monitor_arduino_output(chirp_wav, capsys):
    rc = monitor_main(
        ["-n", NET, "-a", chirp_wav, "--output", "arduino", "--duration", "0.6"]
    )
    assert rc == 0
    out = capsys.readouterr().out
    ev_line = next(
        l for l in out.splitlines() if l.startswith("Arduino events")
    )
    assert int(ev_line.split(":", 1)[1]) > 0


def test_monitor_synthetic_source(capsys):
    """No -a: synthetic per-channel tones still drive the table."""
    rc = monitor_main(["-n", NET, "--duration", "0.4"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "detections per channel" in out


def test_monitor_list_devices(capsys):
    rc = monitor_main(["--list-devices"])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.strip()  # prints either registered devices or the empty notice


def test_monitor_missing_net(capsys):
    with pytest.raises(SystemExit):
        monitor_main([])


def test_monitor_bad_net(tmp_path, capsys):
    bad = tmp_path / "bad.txt"
    bad.write_text("samplingRate = nope\n")
    rc = monitor_main(["-n", str(bad), "--duration", "0.1"])
    assert rc == 1


def test_monitor_interactive_loop(chirp_wav):
    """The GUI control flow as a REPL: load nets per channel, start, inspect
    the table, stop with a detections summary
    (ViewControllerProcessor.swift:116-154, 222-276)."""
    import argparse

    from syllable_detector_tpu.monitor import interactive_loop

    args = argparse.Namespace(
        audio=chirp_wav, duration=0.6, realtime=False
    )
    commands = iter([
        "devices",
        "load onlyonearg",     # bad usage
        "load 0 /nonexistent", # load error path
        f"load 0 {NET}",
        f"load 1 {NET}",
        "table",               # not running yet
        "start",
        "start",               # double start rejected
        "stop",
        "table",               # stopped again
        "bogus",
        "quit",
    ])
    out_lines = []
    rc = interactive_loop(
        args, input_fn=lambda prompt: next(commands), out=out_lines.append
    )
    assert rc == 0
    text = "\n".join(out_lines)
    assert "usage: load CH NET.txt" in text
    assert "load failed" in text
    assert "channel 0 <-" in text and "channel 1 <-" in text
    assert "running: 2 detector(s) over 2 channel(s)" in text
    assert "already running" in text
    assert "unknown command 'bogus'" in text
    det_line = next(l for l in out_lines if "detections per channel" in l)
    dets = eval(det_line.split(":", 1)[1])
    assert len(dets) == 2 and all(d > 0 for d in dets)


def test_monitor_interactive_event_log(chirp_wav, tmp_path):
    """The REPL honors --event-log too: a start/stop session appends the
    CLI-format CSV rows and quit closes the file."""
    import argparse

    from syllable_detector_tpu.monitor import interactive_loop

    log_path = tmp_path / "events.csv"
    args = argparse.Namespace(
        audio=chirp_wav, duration=0.6, realtime=False,
        event_log=str(log_path),
    )
    commands = iter([f"load 0 {NET}", "start", "stop", "quit"])
    out_lines = []
    rc = interactive_loop(
        args, input_fn=lambda prompt: next(commands), out=out_lines.append
    )
    assert rc == 0
    det_line = next(l for l in out_lines if "detections per channel" in l)
    dets = eval(det_line.split(":", 1)[1])
    rows = log_path.read_text().strip().splitlines()
    assert len(rows) == sum(dets) > 0
    assert all(r.startswith("0,") for r in rows)


def test_monitor_interactive_quit_on_eof():
    import argparse

    from syllable_detector_tpu.monitor import interactive_loop

    def raise_eof(prompt):
        raise EOFError

    args = argparse.Namespace(audio=None, duration=0.1, realtime=False)
    assert interactive_loop(args, input_fn=raise_eof, out=lambda s: None) == 0


def test_monitor_interactive_stop_is_prompt_in_realtime(chirp_wav):
    """REPL 'stop' must tear down a --realtime stream immediately (the GUI's
    Stop semantics), not block for the stream's remaining duration."""
    import argparse
    import time

    from syllable_detector_tpu.monitor import interactive_loop

    args = argparse.Namespace(audio=chirp_wav, duration=30.0, realtime=True)
    commands = iter([f"load 0 {NET}", "start", "stop", "quit"])
    t0 = time.monotonic()
    rc = interactive_loop(
        args, input_fn=lambda prompt: next(commands), out=lambda s: None
    )
    elapsed = time.monotonic() - t0
    assert rc == 0
    assert elapsed < 15.0, f"stop blocked for {elapsed:.1f}s"


def test_monitor_resamples_mismatched_wav_rate(tmp_path, capsys):
    """A WAV at a different rate streams at its OWN rate and resamples per
    lane to the net rate (the GUI's mismatched-device-rate path,
    ViewControllerProcessor.swift:247-250) — detections still fire."""
    rate = 22050
    n = int(1.0 * rate)
    rng = np.random.default_rng(4)
    phase = 2 * np.pi * np.cumsum(np.linspace(2000.0, 7000.0, n)) / rate
    t = np.arange(n) / rate
    x = 0.5 * np.sin(phase) + 0.02 * rng.standard_normal(n)
    x = (x * (0.3 + 0.7 * (np.sin(2 * np.pi * 3.0 * t) > 0))).astype(np.float32)
    p = tmp_path / "chirp22k.wav"
    write_wav(p, x, rate, dtype="float32")

    rc = monitor_main(["-n", NET, "-a", str(p), "--duration", "1.0"])
    assert rc == 0
    out = capsys.readouterr().out
    det_line = next(l for l in out.splitlines() if "detections" in l)
    dets = eval(det_line.split(":", 1)[1])
    assert dets[0] > 0


def test_monitor_empty_wav_errors(tmp_path, capsys):
    p = tmp_path / "empty.wav"
    write_wav(p, np.zeros(0, np.float32), 44100, dtype="float32")
    rc = monitor_main(["-n", NET, "-a", str(p), "--duration", "0.2"])
    assert rc == 1
    assert "no samples" in capsys.readouterr().err


def test_monitor_real_input_via_fake_alsa(chirp_wav, capsys, monkeypatch):
    """--input alsa drives the REAL capture path end to end against the
    fake libasound (counter-ramp device) — the reference's live-hardware
    flow without a sound card."""
    import test_alsa
    from syllable_detector_tpu.runtime import alsa as alsa_mod

    fake = test_alsa.FakeAlsa(channels=1)
    monkeypatch.setattr(alsa_mod, "_load_alsa", lambda: fake)
    rc = monitor_main(
        ["-n", NET, "--input", "alsa", "--channels", "1", "--duration", "0.5"]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "detections per channel" in out
    assert fake.pos > 0  # frames were actually read from the device


def test_monitor_real_output_unavailable_errors(capsys, monkeypatch):
    from syllable_detector_tpu.runtime import pulse as pulse_mod

    monkeypatch.setattr(pulse_mod, "_load_pulse", lambda: None)
    rc = monitor_main(
        ["-n", NET, "--output", "pulse", "--duration", "0.1"]
    )
    assert rc == 1
    assert "Unable to open pulse output" in capsys.readouterr().err


def test_monitor_unknown_input_errors(capsys):
    rc = monitor_main(["-n", NET, "--input", "bogus", "--duration", "0.1"])
    assert rc == 1
    assert "Unknown --input" in capsys.readouterr().err


def test_monitor_batched_drain(chirp_wav, capsys):
    """--batched-drain routes all channels through one DetectorBank call;
    detections still fire per channel."""
    rc = monitor_main(
        ["-n", NET, "-a", chirp_wav, "--channels", "2", "--duration", "1.0",
         "--batched-drain"]
    )
    assert rc == 0
    out = capsys.readouterr().out
    det_line = next(
        l for l in out.splitlines() if l.startswith("detections per channel")
    )
    dets = eval(det_line.split(":", 1)[1])
    assert len(dets) == 2 and all(d > 0 for d in dets)


def test_monitor_batched_drain_mixed_geometry(tmp_path, capsys):
    """--batched-drain with mixed-geometry nets now GROUPS lanes into
    per-geometry banks instead of failing (one bank per geometry)."""
    import dataclasses

    from syllable_detector_tpu.config.model_format import (
        dumps_config,
        load_config,
    )

    cfg = load_config(NET)
    other = dataclasses.replace(cfg, scaling="log")
    p_net = tmp_path / "other.txt"
    p_net.write_text(dumps_config(other))
    rc = monitor_main(
        ["-n", NET, "-n", str(p_net), "--channels", "2",
         "--duration", "0.3", "--batched-drain"]
    )
    assert rc == 0
    out = capsys.readouterr().out
    det_line = next(
        l for l in out.splitlines() if l.startswith("detections per channel")
    )
    assert len(eval(det_line.split(":", 1)[1])) == 2


def test_monitor_warm_up_flag(chirp_wav, capsys):
    rc = monitor_main(
        ["-n", NET, "-a", chirp_wav, "--channels", "1", "--duration", "0.5",
         "--warm-up", "--batched-drain"]
    )
    assert rc == 0
    err = capsys.readouterr().err
    assert "warm-up compiled" in err


def test_monitor_arduino_native_output(chirp_wav, capsys):
    """The live pipeline drives the NATIVE C++ firmware end-to-end: TTL
    pin writes land in the native state machine's event log."""
    rc = monitor_main(
        ["-n", NET, "-a", chirp_wav, "--channels", "1", "--duration", "1.0",
         "--output", "arduino-native"]
    )
    assert rc == 0
    out = capsys.readouterr().out
    ev_line = next(
        l for l in out.splitlines() if l.startswith("Arduino events")
    )
    assert int(ev_line.split(":", 1)[1]) > 0


def test_monitor_interactive_start_failure_keeps_repl(tmp_path):
    """A net that PARSES but fails spec validation (freq range past
    Nyquist) must print 'start failed' and keep the REPL alive — not kill
    it with a traceback (main()'s guarded path already did this)."""
    import argparse
    import dataclasses

    from syllable_detector_tpu.config.model_format import dumps_config, load_config
    from syllable_detector_tpu.monitor import interactive_loop

    cfg = load_config(NET)
    bad = dataclasses.replace(cfg, freq_range=(30000.0, 40000.0))
    bad_net = tmp_path / "bad.txt"
    bad_net.write_text(dumps_config(bad))

    args = argparse.Namespace(audio=None, duration=0.2, realtime=False)
    commands = iter([
        f"load 0 {bad_net}",
        "start",          # spec validation raises inside Processor()
        f"load 0 {NET}",  # REPL is still alive: recover with a good net
        "start",
        "stop",
        "quit",
    ])
    out_lines = []
    rc = interactive_loop(
        args, input_fn=lambda p: next(commands), out=out_lines.append
    )
    assert rc == 0
    text = "\n".join(out_lines)
    assert "start failed" in text and "frequency range" in text
    assert "running: 1 detector(s)" in text  # the recovery start worked


@pytest.mark.parametrize("wire", ["int16", "mulaw8"])
def test_monitor_batched_drain_wire_formats(chirp_wav, capsys, wire):
    """--wire-format routes the batched drain through the quantized wire
    (int16 capture-exact; mulaw8 lossy companding tier) — detections
    still fire per channel."""
    rc = monitor_main(
        ["-n", NET, "-a", chirp_wav, "--channels", "2", "--duration", "1.0",
         "--batched-drain", "--wire-format", wire]
    )
    assert rc == 0
    out = capsys.readouterr().out
    det_line = next(
        l for l in out.splitlines() if l.startswith("detections per channel")
    )
    dets = eval(det_line.split(":", 1)[1])
    assert len(dets) == 2 and all(d > 0 for d in dets)
