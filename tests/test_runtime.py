"""Runtime tests: Arduino protocol client vs simulated firmware, audio IO,
and the live Processor pipeline end to end."""

import time

import numpy as np
import pytest

from syllable_detector_tpu.runtime.arduino import (
    ArduinoError,
    ArduinoIO,
    ArduinoPin,
    ArduinoState,
    SimulatedArduinoTransport,
)
from syllable_detector_tpu.runtime.audio_io import (
    AudioDevice,
    SimulatedAudioInput,
    SimulatedAudioOutput,
    add_device_change_listener,
    list_devices,
    register_device,
)
from syllable_detector_tpu.runtime.processor import (
    ArduinoTTLOutput,
    AudioTTLOutput,
    CallbackOutput,
    Processor,
    ProcessorEntry,
)
from test_detector import make_audio


# ---------------------------------------------------------------------------
# Arduino
# ---------------------------------------------------------------------------


def make_arduino(**kw):
    t = SimulatedArduinoTransport(**kw)
    a = ArduinoIO(t, startup_time=0.0)
    return a, t


def test_arduino_handshake_and_state():
    a, t = make_arduino()
    assert a.state == ArduinoState.UNINITIALIZED
    a.open()
    assert a.state == ArduinoState.OPENED
    assert a.sketch == 0  # adio.pde / io


def test_arduino_pin_mode_and_digital_write():
    a, t = make_arduino()
    a.open()
    a.set_pin_mode(7, ArduinoPin.OUTPUT)
    assert t.pins[7] == "output"
    a.write_digital(7, True)
    assert t.digital[7] == 1
    a.write_digital(7, False)
    assert t.digital[7] == 0
    # [48, 97+pin, 48+mode] / [50, 97+pin, 48+val] wire format recorded
    kinds = [e[1] for e in t.events]
    assert kinds == ["mode", "digital", "digital"]


def test_arduino_guards():
    a, t = make_arduino()
    a.open()
    with pytest.raises(ArduinoError, match="Invalid pin"):
        a.set_pin_mode(1, ArduinoPin.OUTPUT)
    with pytest.raises(ArduinoError, match="Invalid pin"):
        a.set_pin_mode(70, ArduinoPin.OUTPUT)
    with pytest.raises(ArduinoError, match="Invalid mode"):
        a.write_digital(7, True)  # not configured as output
    with pytest.raises(ArduinoError, match="Invalid mode"):
        a.set_pin_mode(7, ArduinoPin.UNASSIGNED)


def test_arduino_reads():
    a, t = make_arduino()
    a.open()
    a.set_pin_mode(8, ArduinoPin.INPUT)
    t.digital[8] = 1
    assert a.read_digital(8) is True
    # analog pins < 2 skip the digital-mode guard (ArduinoIO.swift:519)
    t.analog_in[1] = 731
    assert a.read_analog(1) == 731
    # pins >= 2 must be configured as digital inputs first
    with pytest.raises(ArduinoError, match="Invalid mode"):
        a.read_analog(3)
    a.set_pin_mode(3, ArduinoPin.INPUT)
    t.analog_in[3] = 512
    assert a.read_analog(3) == 512


def test_arduino_analog_write_and_pulse():
    a, t = make_arduino()
    a.open()
    a.set_pin_mode(9, ArduinoPin.OUTPUT)
    a.write_analog(9, 200)
    assert t.analog_out[9] == 200
    a.pulse_digital(9)
    assert ("pulse", 9, 1) in [(e[1], e[2], e[3]) for e in t.events]


def test_arduino_startup_queueing():
    """Commands during the 2s startup window queue, then flush on open
    (ArduinoIO.swift:298-331)."""
    t = SimulatedArduinoTransport()
    a = ArduinoIO(t, startup_time=0.1)
    a.open()
    assert a.state == ArduinoState.WAITING_TO_OPEN
    a.set_pin_mode(7, ArduinoPin.OUTPUT)
    a.write_digital(7, True)
    assert 7 not in t.digital  # not sent yet
    deadline = time.monotonic() + 2
    while a.state == ArduinoState.WAITING_TO_OPEN and time.monotonic() < deadline:
        time.sleep(0.01)
    assert a.state == ArduinoState.OPENED
    assert t.digital[7] == 1


def test_arduino_close_drives_pins_low():
    a, t = make_arduino()
    a.open()
    a.set_pin_mode(7, ArduinoPin.OUTPUT)
    a.write_digital(7, True)
    a.close()
    assert a.state == ArduinoState.CLOSED
    assert t.digital[7] == 0


# ---------------------------------------------------------------------------
# audio IO
# ---------------------------------------------------------------------------


def test_device_registry_and_listener():
    seen = []
    add_device_change_listener(lambda: seen.append(1))
    register_device(
        AudioDevice(device_id=1, device_uid="sim:1", device_name="Simulated")
    )
    assert any(d.device_uid == "sim:1" for d in list_devices())
    assert seen


def test_simulated_input_delivers_in_order():
    got = {0: [], 1: []}

    def source(ch, start, n):
        return np.arange(start, start + n, dtype=np.float32) + 1000 * ch

    dev = SimulatedAudioInput(source, channels=2, total_samples=256, frame_size=32)
    dev.delegate = lambda itf, ch, data: got[ch].append(data)
    dev.initialize_audio()
    assert dev.wait_until_done(timeout=10)
    dev.tear_down_audio()
    for ch in (0, 1):
        all_samples = np.concatenate(got[ch])
        np.testing.assert_array_equal(
            all_samples, np.arange(256, dtype=np.float32) + 1000 * ch
        )


def test_simulated_output_render():
    out = SimulatedAudioOutput(channels=2, sample_rate=1000.0)
    out.initialize_audio()
    out.events.append((0.1, 0, 0.05))  # inject deterministic event
    out.events.append((0.2, 1, 0.01))
    wave = out.render(0.5)
    assert wave.shape == (500, 2)
    assert wave[100:150, 0].min() == 1.0 and wave[99, 0] == 0.0
    assert wave[200:210, 1].min() == 1.0


# ---------------------------------------------------------------------------
# processor end-to-end
# ---------------------------------------------------------------------------


def run_processor(sample_config, output, channels=2, seconds=0.6):
    rng = np.random.default_rng(3)
    audio = make_audio(rng, seconds=seconds)

    def source(ch, start, n):
        if ch == 0:
            return audio[start : start + n]
        return 0.001 * np.ones(n, np.float32)  # silent channel: no detections

    total = len(audio)
    interface = SimulatedAudioInput(
        source, channels=channels, total_samples=total, frame_size=512
    )
    entries = [
        ProcessorEntry(input_channel=i, output_channel=i, config=sample_config)
        for i in range(channels)
    ]
    proc = Processor(interface, entries, output)
    proc.set_up()
    assert interface.wait_until_done(timeout=60)
    proc.drain_pending(timeout=30)
    time.sleep(0.3)
    proc.tear_down()
    return proc


def test_processor_audio_ttl(sample_config):
    out_interface = SimulatedAudioOutput(channels=2)
    proc = run_processor(sample_config, AudioTTLOutput(out_interface))
    # channel 0 (chirp) must detect, channel 1 (near-silence) must not
    assert proc._lanes[0].detections > 0
    assert proc._lanes[1].detections == 0
    chans = {ch for _, ch, _ in out_interface.events}
    assert chans == {0}
    # all TTL pulses are 1 ms (Processor.swift:192)
    assert all(d == 0.001 for _, _, d in out_interface.events)


def test_processor_arduino_ttl(sample_config):
    from syllable_detector_tpu.runtime.arduino import (
        ArduinoIO,
        SimulatedArduinoTransport,
    )

    t = SimulatedArduinoTransport()
    a = ArduinoIO(t, startup_time=0.0)
    a.open()
    proc = run_processor(sample_config, ArduinoTTLOutput(a))
    assert proc._lanes[0].detections > 0
    # pin 7+0 configured and driven high at least once (Processor.swift:260, 271)
    assert t.pins[7] == "output"
    highs = [e for e in t.events if e[1] == "digital" and e[2] == 7 and e[3] == 1]
    assert highs
    # silent channel's pin 8 never driven high
    assert not [e for e in t.events if e[1] == "digital" and e[2] == 8 and e[3] == 1]


def test_processor_stats(sample_config):
    seen_flags = []
    proc = run_processor(
        sample_config,
        CallbackOutput(lambda i, e, seen: seen_flags.append((i, seen))),
        channels=1,
    )
    rms = proc.get_input_for_channel(0)
    assert rms is not None and rms > 0.01
    out = proc.get_output_for_channel(0)
    assert out is not None and out > 0.4
    assert any(seen for i, seen in seen_flags)


def test_processor_resamples_mismatched_device_rate(sample_config):
    """A 48k device feeding a 44.1k net goes through the streaming resampler
    (the reference attaches one when rates differ by >1 Hz,
    ViewControllerProcessor.swift:247-250)."""
    dev_rate = 48000.0
    seconds = 0.6
    n = int(seconds * dev_rate)
    t = np.arange(n) / dev_rate
    phase = 2 * np.pi * np.cumsum(np.linspace(2000.0, 7000.0, n)) / dev_rate
    audio = (0.5 * np.sin(phase) * (0.3 + 0.7 * (np.sin(2 * np.pi * 3 * t) > 0))
             ).astype(np.float32)

    def source(ch, start, nn):
        return audio[start : start + nn]

    interface = SimulatedAudioInput(
        source, channels=1, sample_rate=dev_rate, total_samples=n, frame_size=512
    )
    entries = [
        ProcessorEntry(
            input_channel=0, output_channel=0, config=sample_config,
            resample_from=dev_rate,
        )
    ]
    out_interface = SimulatedAudioOutput(channels=1)
    proc = Processor(interface, entries, AudioTTLOutput(out_interface))
    proc.set_up()
    assert interface.wait_until_done(timeout=60)
    proc.drain_pending(timeout=30)
    time.sleep(0.3)
    proc.tear_down()
    # resampler attached and the band sweep still detected at 44.1k
    assert proc._lanes[0].resampler is not None
    assert proc._lanes[0].detections > 0
    assert proc._lanes[0].overflows == 0


def test_serial_transport_full_protocol(monkeypatch):
    """SerialTransport (the pyserial byte transport) driving the simulated
    firmware through a fake `serial` module: the full client protocol —
    handshake, pin mode, digital write/read, pulse, close-drives-low —
    without real hardware."""
    import sys
    import types

    from syllable_detector_tpu.runtime.arduino import SerialTransport

    sim = SimulatedArduinoTransport(sketch_id=0)

    class FakeSerial:
        def __init__(self, port, baudrate, timeout=0):
            assert port == "/dev/ttyFAKE" and baudrate == 115200
            self.closed = False

        def write(self, data):
            sim.write(data)

        def read(self, n):
            with sim._lock:
                if sim._responses:
                    return sim._responses.pop(0)
            return b""

        def close(self):
            self.closed = True

    fake_mod = types.ModuleType("serial")
    fake_mod.Serial = FakeSerial
    monkeypatch.setitem(sys.modules, "serial", fake_mod)

    transport = SerialTransport("/dev/ttyFAKE")
    arduino = ArduinoIO(transport, startup_time=0.0)
    arduino.open()
    assert arduino.state == ArduinoState.OPENED
    assert arduino.sketch == 0  # "99" handshake round-tripped the wire

    arduino.set_pin_mode(8, ArduinoPin.OUTPUT)
    arduino.write_digital(8, True)
    assert sim.digital[8] == 1
    arduino.set_pin_mode(9, ArduinoPin.INPUT)
    sim.digital[9] = 1
    assert arduino.read_digital(9) is True
    arduino.pulse_digital(8)
    assert ("pulse", 8, 1) in [(k, p, v) for _, k, p, v in sim.events]

    port = transport._port
    arduino.close()
    assert port.closed and transport._port is None
    # close drove the configured output pin low (ArduinoIO.swift:370-390)
    assert sim.digital[8] == 0


def test_serial_transport_requires_pyserial(monkeypatch):
    """Without pyserial installed, SerialTransport raises a clear error."""
    import builtins
    import sys

    from syllable_detector_tpu.runtime.arduino import SerialTransport

    monkeypatch.setitem(sys.modules, "serial", None)
    real_import = builtins.__import__

    def fake_import(name, *a, **k):
        if name == "serial":
            raise ImportError("No module named 'serial'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", fake_import)
    with pytest.raises(ArduinoError, match="pyserial is required"):
        SerialTransport("/dev/ttyUSB0")


def test_processor_teardown_after_failed_setup_stops_worker(sample_config):
    """set_up can fail midway (worker already started, audio init raises);
    tear_down must still stop the worker thread — and must stop it even
    when the input teardown raises too (a half-initialized device)."""
    import threading

    class ExplodingInput(SimulatedAudioInput):
        def initialize_audio(self):
            raise OSError("no such capture device")

        def tear_down_audio(self):
            raise OSError("never initialized")

    interface = ExplodingInput(
        lambda ch, start, n: np.zeros(n, np.float32),
        channels=1, total_samples=256,
    )
    entries = [ProcessorEntry(input_channel=0, output_channel=0,
                              config=sample_config)]
    proc = Processor(interface, entries, CallbackOutput(lambda i, e, s: None))
    before = {t.ident for t in threading.enumerate()}
    with pytest.raises(OSError, match="no such capture device"):
        proc.set_up()
    with pytest.raises(OSError, match="never initialized"):
        proc.tear_down()
    assert proc._worker is None
    leaked = [
        t for t in threading.enumerate()
        if t.ident not in before and t.is_alive()
    ]
    assert not leaked


def test_processor_survives_drain_errors(sample_config):
    """A transient failure inside one drain (device/compile hiccup) must not
    kill the sole worker thread — later chunks still detect."""
    seen = []
    output = CallbackOutput(lambda i, e, s: seen.append(s))
    rng = np.random.default_rng(3)
    audio = make_audio(rng, seconds=0.6)

    def source(ch, start, n):
        return audio[start : start + n]

    interface = SimulatedAudioInput(
        source, channels=1, total_samples=len(audio), frame_size=512
    )
    entries = [ProcessorEntry(input_channel=0, output_channel=0,
                              config=sample_config)]
    proc = Processor(interface, entries, output)

    # first two drains explode, the rest work
    lane = proc._lanes[0]
    real_drain = lane.detector.drain
    calls = {"n": 0}

    def flaky_drain():
        calls["n"] += 1
        if calls["n"] <= 2:
            raise RuntimeError("transient device error")
        return real_drain()

    lane.detector.drain = flaky_drain
    proc.set_up()
    assert interface.wait_until_done(timeout=60)
    proc.drain_pending(timeout=30)
    proc.tear_down()
    assert proc.drain_errors == 2
    assert lane.detections > 0  # detection resumed after the failures


def test_arduino_handshake_transport_error():
    """A transport exception during the startup handshake must land in
    ERROR with on_error fired — not leave the client queueing forever."""

    class ExplodingTransport(SimulatedArduinoTransport):
        def write(self, data):
            raise OSError("port vanished")

    errors = []
    arduino = ArduinoIO(ExplodingTransport(), startup_time=0.0)
    arduino.on_error = lambda e, permanent: errors.append((e, permanent))
    arduino.open()
    assert arduino.state == ArduinoState.ERROR
    assert errors and errors[0][1] is True
    with pytest.raises(ArduinoError):
        arduino.set_pin_mode(8, ArduinoPin.OUTPUT)


def test_simulated_arduino_startup_delay():
    """The simulated firmware drops bytes during its boot window (the reason
    the client queues commands, ArduinoIO.swift:298-331); a client whose
    startup_time outlasts the device delay still completes the handshake."""
    transport = SimulatedArduinoTransport(sketch_id=7, startup_delay=0.05)
    transport.open()
    transport.write(b"99")  # lost: device still booting
    assert transport.read_line(0.01) is None
    time.sleep(0.06)
    transport.write(b"99")  # device online now
    assert transport.read_line(0.5) == b"7\r\n"

    arduino = ArduinoIO(
        SimulatedArduinoTransport(sketch_id=3, startup_delay=0.05),
        startup_time=0.15,
    )
    arduino.open()
    arduino.set_pin_mode(8, ArduinoPin.OUTPUT)  # queued during startup
    time.sleep(0.3)
    assert arduino.state == ArduinoState.OPENED and arduino.sketch == 3
    assert arduino.transport.pins[8] == "output"
    arduino.close()


def test_processor_batched_drain(sample_config):
    """batched=True drains every lane in ONE DetectorBank program; the
    detections and TTL behavior must match the per-lane mode."""
    rng = np.random.default_rng(3)
    audio = make_audio(rng, seconds=0.6)

    def source(ch, start, n):
        if ch == 0:
            return audio[start : start + n]
        return 0.001 * np.ones(n, np.float32)

    out_interface = SimulatedAudioOutput(channels=2)
    interface = SimulatedAudioInput(
        source, channels=2, total_samples=len(audio), frame_size=512
    )
    entries = [
        ProcessorEntry(input_channel=i, output_channel=i, config=sample_config)
        for i in range(2)
    ]
    proc = Processor(
        interface, entries, AudioTTLOutput(out_interface), batched=True
    )
    assert proc._bank is not None
    assert proc._lanes[0].detector is None  # no per-lane detectors built
    proc.set_up()
    assert interface.wait_until_done(timeout=60)
    proc.drain_pending(timeout=30)
    time.sleep(0.3)
    proc.tear_down()

    # chirp lane detects, silent lane does not; TTL fired only on channel 0
    det = proc.lane_detections()
    assert det[0] > 0 and det[1] == 0
    assert {ch for _, ch, _ in out_interface.events} == {0}

    # detection count matches the per-lane (unbatched) processor exactly
    ref = run_processor(sample_config, AudioTTLOutput(SimulatedAudioOutput(channels=2)))
    assert det[0] == ref.lane_detections()[0]


def test_processor_lane_stats_age_and_bank_drop_surfacing(sample_config):
    """lane_stats surfaces (a) last-audio age per lane — a dead mic shows
    as a growing age / None (the reference GUI shows its RMS going quiet,
    ViewControllerProcessor.swift:278-284) — and (b) bank-cap drops in
    batched mode, which previously vanished into bank.overflows invisible
    to monitoring."""
    interface = SimulatedAudioInput(
        lambda ch, start, n: np.zeros(n, np.float32),
        channels=2, total_samples=4096, frame_size=512,
    )
    entries = [
        ProcessorEntry(input_channel=i, output_channel=i, config=sample_config)
        for i in range(2)
    ]
    proc = Processor(
        interface, entries, AudioTTLOutput(SimulatedAudioOutput(channels=2)),
        batched=True,
    )
    # feed lane 0 directly (no worker running); lane 1 stays dead
    proc.receive_audio(interface, 0, np.zeros(1024, np.float32))
    stats = proc.lane_stats()
    assert stats[0]["last_audio_age_s"] is not None
    assert 0.0 <= stats[0]["last_audio_age_s"] < 10.0
    assert stats[1]["last_audio_age_s"] is None  # dead mic: never delivered
    assert stats[0]["dropped_samples"] == 0

    # force a bank-cap drop and run one batched drain round: the loss must
    # land on the LANE's counters, not only inside the bank
    proc._bank.max_buffer_samples = 100
    proc.receive_audio(interface, 0, np.zeros(500, np.float32))
    proc._drain_all()
    stats = proc.lane_stats()
    assert stats[0]["overflows"] == 1
    assert stats[0]["dropped_samples"] >= 500
    assert proc._bank.overflows[0] == 1  # and the bank counted it too


def test_processor_batched_mixed_geometry_groups(sample_config):
    """batched=True with MIXED-geometry nets: lanes group into per-geometry
    DetectorBanks (the GUI can load arbitrary nets per row); detections
    still fire per lane."""
    import dataclasses

    other = dataclasses.replace(sample_config, scaling="log")
    rng = np.random.default_rng(3)
    audio = make_audio(rng, seconds=0.5)

    def source(ch, start, n):
        return audio[start : start + n]

    out_interface = SimulatedAudioOutput(channels=3)
    interface = SimulatedAudioInput(
        source, channels=3, total_samples=len(audio), frame_size=512
    )
    entries = [
        ProcessorEntry(input_channel=0, output_channel=0, config=sample_config),
        ProcessorEntry(input_channel=1, output_channel=1, config=other),
        ProcessorEntry(input_channel=2, output_channel=2, config=sample_config),
    ]
    proc = Processor(
        interface, entries, AudioTTLOutput(out_interface), batched=True
    )
    assert len(proc._banks) == 2  # two geometry groups (linear x2, log x1)
    assert proc._bank is None  # no single-group alias with mixed geometry
    proc.set_up()
    assert interface.wait_until_done(timeout=60)
    proc.drain_pending(timeout=30)
    time.sleep(0.3)
    proc.tear_down()
    det = proc.lane_detections()
    # the linear-scaling chirp lanes detect; all lanes processed
    assert det[0] > 0 and det[2] > 0
    assert det[0] == det[2]  # same net, same audio


def test_native_firmware_full_protocol():
    """The FULL ArduinoIO client protocol against the NATIVE C++ firmware
    (native/arduino_firmware.cpp — the host-compiled counterpart of the
    reference's Arduino.ino), cross-checked event-for-event against the
    Python-simulated firmware."""
    from syllable_detector_tpu.runtime.arduino import (
        ArduinoIO,
        ArduinoPin,
        NativeFirmwareTransport,
        SimulatedArduinoTransport,
    )

    fw = NativeFirmwareTransport(sketch_id=0)
    a = ArduinoIO(fw, startup_time=0.0)
    a.open()
    assert a.sketch is not None  # handshake "99" answered by native code

    a.set_pin_mode(7, ArduinoPin.OUTPUT)
    assert fw.pin_mode(7) == 1
    a.write_digital(7, True)
    assert fw.digital(7) == 1
    a.write_digital(7, False)
    assert fw.digital(7) == 0

    a.set_pin_mode(9, ArduinoPin.INPUT)
    assert fw.pin_mode(9) == 0
    assert a.read_digital(9) is False

    a.set_pin_mode(11, ArduinoPin.OUTPUT)
    a.write_analog(11, 200)
    assert fw.analog_out(11) == 200
    fw.set_analog_in(1, 777)  # pins 0/1 need no mode (ArduinoIO.swift:514)
    assert a.read_analog(1) == 777

    a.set_pin_mode(5, ArduinoPin.OUTPUT)
    a.pulse_digital(5)
    events = fw.drain_events()
    kinds = [(k, p, v) for (k, p, v) in events]
    # mode(7,out), digital(7,1), digital(7,0), mode(9,in), analog(11,200),
    # pulse(5,1) — same sequence the Python firmware records
    assert (0, 7, 1) in kinds and (1, 7, 1) in kinds and (1, 7, 0) in kinds
    assert (0, 9, 0) in kinds and (2, 11, 200) in kinds and (3, 5, 1) in kinds

    # close drives configured OUTPUT pins low (ArduinoIO.swift:370-390)
    a.write_digital(7, True)
    a.close()
    assert fw.digital(7) == 0

    # byte-level cross-check: the same raw client byte stream produces the
    # same pin state in native and Python firmwares
    sim = SimulatedArduinoTransport()
    sim.open()
    fw2 = NativeFirmwareTransport()
    stream = bytes([48, 97 + 8, 49]) + bytes([50, 97 + 8, 49]) + bytes(
        [52, 97 + 10, 123]
    ) + b"\xff\x00" + bytes([50, 97 + 8, 48])  # incl. garbage resync
    sim.write(stream)
    fw2.write(stream)
    assert sim.pins[8] == "output" and fw2.pin_mode(8) == 1
    assert sim.digital[8] == 0 and fw2.digital(8) == 0
    assert sim.analog_out[10] == 123 and fw2.analog_out(10) == 123
    fw2.dispose()
    fw.dispose()


def test_live_end_to_end_ttl_latency(sample_config):
    """Wall-clock closed-loop latency: a syllable onset in a REALTIME
    simulated stream must raise the audio TTL within a bounded delay —
    onset + first-decision fill (~33 ms, TrackDetector.swift:38-42) +
    drain batching + scheduling. The reference claims <=5 ms of ADDED
    output path delay (README.md:30); here the whole loop (capture ->
    ring -> worker -> device -> TTL) is bounded loosely for CI noise."""
    rng = np.random.default_rng(77)
    onset = 0.4  # seconds into the stream
    chirp = make_audio(rng, seconds=1.0)

    def source(ch, start, n):
        t0 = start / 44100.0
        out = np.zeros(n, np.float32)
        idx = np.arange(start, start + n)
        m = idx >= int(onset * 44100)
        if m.any():
            out[m] = chirp[idx[m] - int(onset * 44100)]
        return out

    out_interface = SimulatedAudioOutput(channels=1)
    interface = SimulatedAudioInput(
        source, channels=1, total_samples=44100, frame_size=32, realtime=True
    )
    entries = [
        ProcessorEntry(input_channel=0, output_channel=0, config=sample_config)
    ]
    proc = Processor(interface, entries, AudioTTLOutput(out_interface))
    # pre-compile the drain shapes so the first live drain is math, not jit
    proc.warm_up(buckets=(8, 32, 128))
    proc.set_up()
    assert interface.wait_until_done(timeout=30)
    proc.drain_pending(timeout=30)
    proc.tear_down()

    assert out_interface.events, "no TTL fired for the chirp"
    first_ttl = min(t for t, ch, d in out_interface.events)
    # both clocks start at set_up (capture thread t0 vs output _t0)
    latency = first_ttl - onset
    # expected floor: first decision needs window + hop*(timeRange-1)
    # samples of syllable audio ~= 32.7 ms after onset
    fill = sample_config.first_output_sample / sample_config.sampling_rate
    assert latency >= 0.8 * fill, (latency, fill)
    # generous CI bound: fill + drain batching + host scheduling
    assert latency < 0.35, latency


# ---------------------------------------------------------------------------
# capture-gap propagation (ring overflow -> detector/bank discontinuity)
# ---------------------------------------------------------------------------


def test_processor_long_stream_soak_invariants(sample_config):
    """Endurance under sustained pressure: 20 s of audio delivered as fast
    as the simulated device can (the non-realtime source outruns the 10 s
    ring, forcing hundreds of genuine overflow drops) must leave NO
    unbounded bookkeeping behind and keep the accounting exact — every
    delivered sample either produced or counted dropped, every produced
    sample appended, gap events acked and trimmed, bank buffers holding
    only the sliding-window history. These are the structural guards
    against the leak class (lists/buffers that only ever grow) that a
    short functional test cannot catch."""
    rng = np.random.default_rng(21)
    audio = make_audio(rng, seconds=20.0)

    def source(ch, start, n):
        if ch == 0:
            return audio[start : start + n]
        return 0.001 * np.ones(n, np.float32)

    interface = SimulatedAudioInput(
        source, channels=2, total_samples=len(audio), frame_size=512
    )
    entries = [
        ProcessorEntry(input_channel=i, output_channel=i, config=sample_config)
        for i in range(2)
    ]
    proc = Processor(
        interface, entries, CallbackOutput(lambda *a: None),
        batched=True,
    )
    proc.set_up()
    assert interface.wait_until_done(timeout=120)
    proc.drain_pending(timeout=60)
    proc.tear_down()

    spec = proc._bank.spec
    history_samples = spec.first_output_sample  # window + (T-1) hops
    for lane in proc._lanes:
        # exact loss accounting: every delivered sample is either in the
        # produced stream or counted in a recorded drop
        assert lane.produced_samples + lane.dropped_samples == len(audio)
        assert lane.appended_samples == lane.produced_samples
        # bounded bookkeeping: acked gap events are trimmed; at most a
        # trailing few (drops after the final produced chunk) may remain
        assert len(lane.gap_events) <= 4
        assert lane.ring.fill < 2 * 512  # worker kept consuming
    for j in range(2):
        # only the sliding-window tail (plus < one chunk of unframed
        # residue) may stay buffered — bounded, not stream-proportional
        assert proc._bank.buffered_samples(j) <= history_samples + 512
        # segments collapse as gaps drain: closed+drained ones are freed
        assert len(proc._bank._segments[j]) <= 2
    assert proc._work.unfinished_tasks == 0
    assert proc._lanes[0].detections > 0
    assert proc._lanes[1].detections == 0


def test_feed_with_gaps_splices_at_true_positions(sample_config):
    """_feed_with_gaps places each recorded overflow hole at its exact
    produced-sample position, even when pre- and post-gap samples sit in
    the consumed chunk together, and coalesces the acked event prefix."""
    interface = SimulatedAudioInput(
        lambda ch, s, n: np.zeros(n, np.float32), channels=1, total_samples=0
    )
    proc = Processor(
        interface,
        [ProcessorEntry(0, 0, sample_config)],
        CallbackOutput(lambda *a: None),
    )
    lane = proc._lanes[0]
    events = []
    append = lambda chunk: events.append(("a", len(chunk)))
    gap = lambda n: events.append(("g", n))

    # two consecutive drops at produced=100, then samples 0..159 arrive
    lane.gap_events.extend([(100, 50), (100, 30)])
    proc._feed_with_gaps(lane, np.zeros(160, np.float32), append, gap)
    assert events == [("a", 100), ("g", 50), ("g", 30), ("a", 60)]
    assert lane.appended_samples == 160
    assert lane.gap_events == [] and lane.gap_acked == 0  # acked + trimmed

    # a gap beyond the consumed samples waits for the next round
    events.clear()
    lane.gap_events.append((200, 10))
    proc._feed_with_gaps(lane, np.zeros(30, np.float32), append, gap)
    assert events == [("a", 30)]  # 160+30=190 < 200: hole not reached yet
    proc._feed_with_gaps(lane, np.zeros(10, np.float32), append, gap)
    assert events == [("a", 30), ("a", 10), ("g", 10)]
    assert lane.appended_samples == 200 and lane.gap_events == []


def test_ring_overflow_gap_propagates_to_bank(sample_config):
    """A chunk dropped at the FULL ring must become a bank note_gap at its
    true stream position: post-gap outputs carry sample-accurate indices
    and match an oracle bank fed the same gapped stream — not silently
    spliced onto pre-gap audio (the reference's accounting is
    sample-accurate, SyllableDetectorCLI/TrackDetector.swift:67-68)."""
    rng = np.random.default_rng(7)
    pre = make_audio(rng, seconds=0.2)
    lost = make_audio(rng, seconds=0.3)
    post = make_audio(rng, seconds=0.2)
    rate = sample_config.sampling_rate

    interface = SimulatedAudioInput(
        lambda ch, s, n: np.zeros(n, np.float32), channels=1, total_samples=0
    )
    proc = Processor(
        interface,
        [ProcessorEntry(0, 0, sample_config)],
        CallbackOutput(lambda *a: None),
        batched=True,
        ring_seconds=(len(pre) + 16) / rate,  # pre fits; lost overflows
    )
    lane = proc._lanes[0]
    proc.receive_audio(interface, 0, pre)
    proc.receive_audio(interface, 0, lost)  # ring full -> dropped + recorded
    assert lane.overflows == 1 and lane.dropped_samples == len(lost)
    proc._drain_all()
    got_pre = proc._bank.last_outputs.copy()
    idx_pre = proc._bank.last_sample_indices[0].copy()
    proc.receive_audio(interface, 0, post)
    proc._drain_all()
    got_post = proc._bank.last_outputs.copy()
    idx_post = proc._bank.last_sample_indices[0].copy()

    from syllable_detector_tpu.models.detector_bank import DetectorBank

    oracle = DetectorBank([sample_config])
    oracle.append_audio_data(0, pre)
    oracle.drain()
    np.testing.assert_array_equal(idx_pre, oracle.last_sample_indices[0])
    np.testing.assert_array_equal(got_pre, oracle.last_outputs)
    oracle.note_gap(0, len(lost))
    oracle.append_audio_data(0, post)
    oracle.drain()
    np.testing.assert_array_equal(idx_post, oracle.last_sample_indices[0])
    np.testing.assert_array_equal(got_post, oracle.last_outputs)
    # post-gap indices are in the TRUE stream domain (past pre+lost)
    assert len(idx_post) and idx_post[0] >= len(pre) + len(lost)


def test_capture_gap_splices_to_bank(sample_config):
    """A DEVICE-side loss (ALSA xrun -> interface.gap_delegate) must land
    in the detection stream exactly like a ring-overflow drop: post-gap
    outputs carry sample-accurate indices matching an oracle bank fed the
    same gapped stream."""
    rng = np.random.default_rng(11)
    pre = make_audio(rng, seconds=0.2)
    post = make_audio(rng, seconds=0.2)
    n_lost = 4321

    interface = SimulatedAudioInput(
        lambda ch, s, n: np.zeros(n, np.float32), channels=1, total_samples=0
    )
    proc = Processor(
        interface,
        [ProcessorEntry(0, 0, sample_config)],
        CallbackOutput(lambda *a: None),
        batched=True,
    )
    assert interface.gap_delegate == proc.receive_capture_gap
    lane = proc._lanes[0]
    proc.receive_audio(interface, 0, pre)
    proc.receive_capture_gap(interface, n_lost)
    assert lane.capture_gaps == 1
    assert lane.capture_lost_samples == n_lost
    proc.receive_audio(interface, 0, post)
    proc._drain_all()
    got = proc._bank.last_outputs.copy()
    idx = proc._bank.last_sample_indices[0].copy()

    from syllable_detector_tpu.models.detector_bank import DetectorBank

    oracle = DetectorBank([sample_config])
    oracle.append_audio_data(0, pre)
    oracle.note_gap(0, n_lost)
    oracle.append_audio_data(0, post)
    oracle.drain()
    np.testing.assert_array_equal(idx, oracle.last_sample_indices[0])
    np.testing.assert_array_equal(got, oracle.last_outputs)
    assert proc.lane_stats()[0]["capture_lost_samples"] == n_lost


def test_capture_gap_resampler_lane_converts_and_resets(sample_config):
    """On a resampled lane the device-frame loss converts to lane-rate
    samples and the resampler carry (pre-gap audio) restarts fresh."""
    rate = sample_config.sampling_rate
    interface = SimulatedAudioInput(
        lambda ch, s, n: np.zeros(n, np.float32), channels=1, total_samples=0
    )
    proc = Processor(
        interface,
        [ProcessorEntry(0, 0, sample_config, resample_from=2 * rate)],
        CallbackOutput(lambda *a: None),
    )
    lane = proc._lanes[0]
    # advance the resampler carry off its initial state
    proc.receive_audio(interface, 0, np.ones(1001, np.float32))
    carried = lane.resampler
    proc.receive_capture_gap(interface, 1000)
    assert lane.capture_lost_samples == 500  # 2:1 device->lane rate
    assert lane.resampler is not carried  # continuity broke: fresh state
    assert lane.gap_events[-1] == (lane.produced_samples, 500)


def test_event_log_per_lane_matches_batched_and_oracle(sample_config):
    """The live event log carries sample-accurate stream indices in BOTH
    drain modes, agreeing with each other and with a DetectorBank oracle
    fed the same gapped stream — including across a device-loss gap."""
    rng = np.random.default_rng(13)
    pre = make_audio(rng, seconds=0.25)
    post = make_audio(rng, seconds=0.25)
    n_lost = 3333

    def run(batched):
        events = []
        interface = SimulatedAudioInput(
            lambda ch, s, n: np.zeros(n, np.float32), channels=1,
            total_samples=0,
        )
        proc = Processor(
            interface,
            [ProcessorEntry(0, 0, sample_config)],
            CallbackOutput(lambda *a: None),
            batched=batched,

            event_log=lambda ch, s, t, o: events.append(
                (ch, s, t, tuple(np.asarray(o).tolist()))
            ),
        )
        lane = proc._lanes[0]
        drain = (lambda: proc._drain_all()) if batched else (
            lambda: proc._drain_lane(0, lane)
        )
        proc.receive_audio(interface, 0, pre)
        drain()
        proc.receive_capture_gap(interface, n_lost)
        proc.receive_audio(interface, 0, post)
        drain()
        return events

    per_lane = run(batched=False)
    batched = run(batched=True)
    # stream indices agree EXACTLY across modes; outputs to float ulps
    # (the padded batched evaluation reduces in a different order)
    assert [(e[0], e[1], e[2]) for e in per_lane] == [
        (e[0], e[1], e[2]) for e in batched
    ]
    np.testing.assert_allclose(
        [e[3] for e in per_lane], [e[3] for e in batched],
        rtol=1e-5, atol=1e-6,
    )
    assert len(per_lane) > 0

    # oracle: the bank's own sample accounting on the same gapped stream
    from syllable_detector_tpu.models.detector_bank import DetectorBank

    spec_thr = np.float32(sample_config.thresholds[0])
    rate = sample_config.sampling_rate
    want = []
    oracle = DetectorBank([sample_config])
    for feed in (pre, None, post):
        if feed is None:
            oracle.note_gap(0, n_lost)
            continue
        oracle.append_audio_data(0, feed)
        outs = oracle.drain()
        o = outs[0, : oracle.last_counts[0]]
        idx = oracle.last_sample_indices[0]
        for k in np.flatnonzero(o[:, 0] >= spec_thr):
            want.append(
                (0, int(idx[k]), float(idx[k] / rate),
                 tuple(np.asarray(o[k]).tolist()))
            )
    assert [(e[0], e[1], e[2]) for e in per_lane] == [
        (e[0], e[1], e[2]) for e in want
    ]
    np.testing.assert_allclose(
        [e[3] for e in per_lane], [e[3] for e in want],
        rtol=1e-5, atol=1e-6,
    )
    # and a gap really sits between the two bursts: post-gap indices jump
    assert any(s >= len(pre) + n_lost for _, s, _, _ in per_lane)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("seed", [41, 42])
def test_processor_gap_splice_fuzz(sample_config, batched, seed):
    """Adversarial interleaving of capture chunks, device-loss gaps, and
    drains through the live Processor: the event log's (sample, outputs)
    sequence must match a DetectorBank oracle fed the same event stream —
    consecutive gaps, gaps without data between, drains at arbitrary
    points. Pins the per-lane stream clock against the bank's segment
    accounting in both drain modes."""
    from syllable_detector_tpu.models.detector_bank import DetectorBank

    rng = np.random.default_rng(seed)
    stream = make_audio(rng, seconds=1.0)
    rate = sample_config.sampling_rate
    thr = np.float32(sample_config.thresholds[0])

    got = []
    interface = SimulatedAudioInput(
        lambda ch, s, n: np.zeros(n, np.float32), channels=1, total_samples=0
    )
    proc = Processor(
        interface,
        [ProcessorEntry(0, 0, sample_config)],
        CallbackOutput(lambda *a: None),
        batched=batched,

        event_log=lambda ch, s, t, o: got.append((s, tuple(np.round(o, 4)))),
    )
    lane = proc._lanes[0]
    drain = (lambda: proc._drain_all()) if batched else (
        lambda: proc._drain_lane(0, lane)
    )

    oracle = DetectorBank([sample_config])
    want = []

    def oracle_drain():
        outs = oracle.drain()
        o = outs[0, : oracle.last_counts[0]]
        idx = oracle.last_sample_indices[0]
        for k in np.flatnonzero(o[:, 0] >= thr):
            want.append((int(idx[k]), tuple(np.round(o[k], 4))))

    pos = 0
    for _ in range(40):
        r = rng.random()
        if r < 0.5:  # capture chunk
            n = int(rng.integers(40, 3000))
            chunk = stream[pos : pos + n]
            pos = (pos + n) % (len(stream) - 3000)
            if len(chunk):
                proc.receive_audio(interface, 0, chunk)
                oracle.append_audio_data(0, chunk)
        elif r < 0.72:  # device-loss gap (may repeat with no data between)
            n = int(rng.integers(1, 5000))
            proc.receive_capture_gap(interface, n)
            oracle.note_gap(0, n)
        else:
            drain()
            oracle_drain()
    drain()
    oracle_drain()

    assert len(got) > 0
    assert [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose(
        [o for _, o in got], [o for _, o in want], rtol=1e-4, atol=1e-5
    )


def test_ring_overflow_gap_rewarmups_per_lane_detector(sample_config):
    """Per-lane mode: the worker flushes evaluable pre-gap hops, then
    note_gap re-warms the Detector, so post-gap outputs match a fresh
    detector fed only the post-gap audio."""
    rng = np.random.default_rng(9)
    pre = make_audio(rng, seconds=0.2)
    lost = make_audio(rng, seconds=0.3)
    post = make_audio(rng, seconds=0.2)
    rate = sample_config.sampling_rate

    interface = SimulatedAudioInput(
        lambda ch, s, n: np.zeros(n, np.float32), channels=1, total_samples=0
    )
    proc = Processor(
        interface,
        [ProcessorEntry(0, 0, sample_config)],
        CallbackOutput(lambda *a: None),
        ring_seconds=(len(pre) + 16) / rate,
    )
    lane = proc._lanes[0]
    proc.receive_audio(interface, 0, pre)
    proc.receive_audio(interface, 0, lost)  # dropped
    proc._drain_lane(0, lane)
    proc.receive_audio(interface, 0, post)
    proc._drain_lane(0, lane)

    from syllable_detector_tpu.models.detector import Detector

    # the lane's detector state equals a fresh stream fed only `post`
    oracle = Detector(sample_config)
    oracle.append_audio_data(post)
    oracle.drain()
    np.testing.assert_array_equal(lane.detector.last_outputs, oracle.last_outputs)
    np.testing.assert_array_equal(
        np.asarray(lane.detector._residual), np.asarray(oracle._residual)
    )
    assert lane.detector._frames_seen == oracle._frames_seen


def test_batched_ttl_decay_once_per_capture_chunk(sample_config):
    """Quiet-drain TTL decay fires only for lanes whose capture chunk the
    round consumed: a fast worker waking once per enqueued item must not
    decay the Arduino 20-drain hold n_lanes times per capture round."""
    interface = SimulatedAudioInput(
        lambda ch, s, n: np.zeros(n, np.float32), channels=2, total_samples=0
    )
    entries = [
        ProcessorEntry(input_channel=i, output_channel=i, config=sample_config)
        for i in range(2)
    ]
    calls = []
    proc = Processor(
        interface,
        entries,
        CallbackOutput(lambda i, e, s: calls.append((i, s))),
        batched=True,
    )
    proc._drain_all({1})  # only lane 1's chunk this round
    assert calls == [(1, False)]
    calls.clear()
    proc._drain_all()  # default: all lanes (direct-call compatibility)
    assert calls == [(0, False), (1, False)]


def test_output_backend_errors_counted_not_swallowed(sample_config, capsys):
    """An output backend that raises (unplugged Arduino) is counted and
    logged — TTL silently stopping with healthy-looking stats was
    invisible before (Processor.swift:272-276 logs and continues)."""

    def boom(i, e, s):
        raise OSError("serial port gone")

    interface = SimulatedAudioInput(
        lambda ch, s, n: np.zeros(n, np.float32), channels=1, total_samples=0
    )
    proc = Processor(
        interface,
        [ProcessorEntry(0, 0, sample_config)],
        CallbackOutput(boom),
    )
    proc.receive_audio(interface, 0, np.zeros(2048, np.float32))
    proc._drain_lane(0, proc._lanes[0])
    assert proc.output_errors == 1
    assert "output backend error" in capsys.readouterr().err

    # batched mode counts too
    proc_b = Processor(
        interface,
        [ProcessorEntry(0, 0, sample_config)],
        CallbackOutput(boom),
        batched=True,
    )
    proc_b._drain_all()
    assert proc_b.output_errors == 1


def test_processor_bank_knobs_pass_through(sample_config):
    """The live-deployment knobs reach the bank: bounded backlog cap,
    pinned bucket ladder (one compiled shape per bucket), int16 wire."""
    interface = SimulatedAudioInput(
        lambda ch, start, n: np.zeros(n, np.float32), channels=1,
        total_samples=0,
    )
    entries = [
        ProcessorEntry(input_channel=0, output_channel=0, config=sample_config)
    ]
    proc = Processor(
        interface, entries, CallbackOutput(lambda i, e, s: None),
        batched=True, bank_buffer_seconds=5.0, bank_buckets=(32, 128),
        bank_transfer_dtype="int16",
    )
    bank = proc._bank
    assert bank.max_buffer_samples == int(5.0 * sample_config.sampling_rate)
    assert bank._buckets == (32, 128)
    assert bank.transfer_dtype == "int16"


def test_processor_drain_interval_coalesces(sample_config):
    """drain_interval holds a batching window open: capture chunks
    coalesce into far fewer bank drains (the transfer-bound live trade),
    while detections still match the unthrottled batched processor."""
    rng = np.random.default_rng(11)
    audio = make_audio(rng, seconds=0.6)

    def run(drain_interval):
        interface = SimulatedAudioInput(
            lambda ch, start, n: audio[start : start + n],
            channels=1, total_samples=len(audio), frame_size=512,
            realtime=False,
        )
        entries = [
            ProcessorEntry(
                input_channel=0, output_channel=0, config=sample_config
            )
        ]
        proc = Processor(
            interface, entries, CallbackOutput(lambda i, e, s: None),
            batched=True, drain_interval=drain_interval,
        )
        drains = []
        bank = proc._bank
        orig = bank.drain

        def counted():
            drains.append(time.monotonic())
            return orig()

        bank.drain = counted
        proc.set_up()
        assert interface.wait_until_done(timeout=60)
        proc.drain_pending(timeout=30)
        proc.tear_down()
        return proc.lane_detections()[0], drains

    det_throttled, drains_throttled = run(0.25)
    det_free, _ = run(0.0)
    assert det_throttled == det_free and det_throttled > 0
    # 0.6 s of audio under a 0.25 s window: a handful of drains at most
    assert len(drains_throttled) <= 6
    # consecutive mid-stream drains respect the window (the first may
    # fire immediately; teardown may add a final flush)
    gaps = np.diff(drains_throttled)
    if len(gaps) > 1:
        assert np.all(gaps[:-1] >= 0.2)


def test_simulated_input_block_delivery():
    """When block_delegate is set the simulator delivers ONE [C, n] block
    per tick (and never calls the per-channel delegate); content matches
    the per-channel contract exactly."""

    def source(ch, start, n):
        return np.arange(start, start + n, dtype=np.float32) + 1000 * ch

    blocks = []
    per_channel = []
    dev = SimulatedAudioInput(source, channels=3, total_samples=128,
                              frame_size=32)
    dev.delegate = lambda itf, ch, data: per_channel.append(ch)
    dev.block_delegate = lambda itf, block: blocks.append(block.copy())
    dev.initialize_audio()
    assert dev.wait_until_done(timeout=10)
    dev.tear_down_audio()
    assert not per_channel  # block path replaces per-channel calls
    assert len(blocks) == 4 and all(b.shape == (3, 32) for b in blocks)
    glued = np.concatenate(blocks, axis=1)
    for ch in range(3):
        np.testing.assert_array_equal(
            glued[ch], np.arange(128, dtype=np.float32) + 1000 * ch
        )


def test_processor_block_path_matches_per_channel(sample_config):
    """receive_audio_block must be bookkeeping-identical to C
    receive_audio calls: detections, stats, produced samples, and
    overflow gap events (the bulk path exists purely to cut the Python
    fan-out cost — r5 live campaign measured 0.26%/lane of a core)."""
    rng = np.random.default_rng(3)
    audio = make_audio(rng, seconds=0.6)

    def source(ch, start, n):
        if ch == 0:
            return audio[start : start + n]
        return 0.001 * np.ones(n, np.float32)

    results = {}
    for mode in ("block", "per_channel"):
        interface = SimulatedAudioInput(
            source, channels=2, total_samples=len(audio), frame_size=512
        )
        entries = [
            ProcessorEntry(input_channel=i, output_channel=i,
                           config=sample_config)
            for i in range(2)
        ]
        out = CallbackOutput(lambda i, e, s: None)
        proc = Processor(interface, entries, out)
        if mode == "per_channel":
            interface.block_delegate = None  # force the per-channel path
        proc.set_up()
        assert interface.wait_until_done(timeout=60)
        proc.drain_pending(timeout=30)
        proc.tear_down()
        results[mode] = {
            "detections": proc.lane_detections(),
            "produced": [l.produced_samples for l in proc._lanes],
            "stats": [proc.get_input_for_channel(i) is not None
                      for i in range(2)],
        }
    assert results["block"] == results["per_channel"]


def test_capture_gap_splices_between_blocks(sample_config):
    """A device-side gap landing BETWEEN bulk block deliveries
    (receive_audio_block) splices at the same stream position as the
    per-channel path: outputs and indices match an oracle bank fed the
    identical gapped stream on every lane."""
    rng = np.random.default_rng(12)
    pre = make_audio(rng, seconds=0.2)
    post = make_audio(rng, seconds=0.2)
    n_lost = 2345
    lanes = 3

    interface = SimulatedAudioInput(
        lambda ch, s, n: np.zeros(n, np.float32), channels=lanes,
        total_samples=0,
    )
    proc = Processor(
        interface,
        [ProcessorEntry(i, i, sample_config) for i in range(lanes)],
        CallbackOutput(lambda *a: None),
        batched=True,
    )
    assert proc._block_writer is not None
    pre_b = np.stack([pre * (1.0 + 0.1 * i) for i in range(lanes)])
    post_b = np.stack([post * (1.0 + 0.1 * i) for i in range(lanes)])
    proc.receive_audio_block(interface, pre_b)
    proc.receive_capture_gap(interface, n_lost)
    proc.receive_audio_block(interface, post_b)
    proc._drain_all()

    from syllable_detector_tpu.models.detector_bank import DetectorBank

    oracle = DetectorBank([sample_config] * lanes)
    for i in range(lanes):
        oracle.append_audio_data(i, pre_b[i])
        oracle.note_gap(i, n_lost)
        oracle.append_audio_data(i, post_b[i])
    oracle.drain()
    for i in range(lanes):
        np.testing.assert_array_equal(
            proc._bank.last_sample_indices[i], oracle.last_sample_indices[i]
        )
        assert proc.lane_stats()[i]["capture_lost_samples"] == n_lost
    np.testing.assert_array_equal(
        proc._bank.last_outputs, oracle.last_outputs
    )
