"""Live multi-channel monitor — the headless equivalent of the reference GUI.

The reference's processor window pairs input channel i with output channel i,
loads one network per channel, and refreshes input-RMS / max-output level
columns at 10 Hz (reference: SyllableDetector/ViewControllerProcessor.swift:
57, 110-154, 278-284). This CLI drives the same Processor pipeline headlessly
over a simulated device (WAV-backed or synthetic), printing the channel table
periodically and TTL events at the end.

Usage:
  python -m syllable_detector_tpu.monitor -n NET.txt -a IN.wav [--channels N]
                                          [--output audio|arduino]
                                          [--duration SECONDS] [--realtime]
  python -m syllable_detector_tpu.monitor --interactive [...]

``--interactive`` is the GUI's control loop as a REPL: load a network per
channel row, start/stop the processor, inspect the level table — the
ViewControllerMenu -> ViewControllerProcessor flow
(ViewControllerMenu.swift:163-225, ViewControllerProcessor.swift:116-154,
222-276) without a window server.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from syllable_detector_tpu.config.model_format import ConfigError, load_config
from syllable_detector_tpu.runtime.arduino import ArduinoIO, SimulatedArduinoTransport
from syllable_detector_tpu.runtime.audio_io import (
    SimulatedAudioInput,
    SimulatedAudioOutput,
)
from syllable_detector_tpu.runtime.processor import (
    ArduinoTTLOutput,
    AudioTTLOutput,
    Processor,
    ProcessorEntry,
)
from syllable_detector_tpu.utils.wav import read_audio
from syllable_detector_tpu.utils.compile_cache import enable_compile_cache

__all__ = ["main"]


def _drain_grace() -> float:
    """Final-drain timeout: device compiles must not stall the last
    chunk's results; on non-CPU backends give it a compile-sized window."""
    try:
        import jax

        return 900.0 if jax.default_backend() != "cpu" else 10.0
    except Exception:  # pragma: no cover
        return 10.0


def interactive_loop(args, input_fn=input, out=print) -> int:
    """The GUI control flow as a REPL (testable via injected input_fn).

    Commands:
      load CH NET.txt   assign a network to channel row CH
                        (double-click-to-load, ViewControllerProcessor.swift:222-276)
      start | stop      construct/tear down the Processor
                        (the Start/Stop button, ViewControllerProcessor.swift:116-154)
      table             print the level columns (the 10 Hz refresh)
      devices           list registered audio devices
      quit              stop and exit
    """
    from syllable_detector_tpu.runtime.audio_io import list_devices

    rate = 44100.0
    configs: dict[int, object] = {}
    proc = None
    interface = None
    output = None
    event_log = None
    event_fh = None
    if getattr(args, "event_log", None):
        from syllable_detector_tpu.runtime.processor import csv_event_log

        try:
            event_fh = open(args.event_log, "a")
        except OSError as e:
            out(f"Unable to open --event-log: {e}")
            return 1
        event_log = csv_event_log(event_fh)

    def make_source(audio_path):
        """-> (source fn, device rate): a WAV streams at its OWN rate (a
        mismatch with the net rate adds a per-lane resampler, the GUI's
        ViewControllerProcessor.swift:247-250 path)."""
        if audio_path:
            wav, wav_rate = read_audio(audio_path)
            mono = np.ascontiguousarray(wav[:, 0])
            if not len(mono):
                raise ValueError(f"{audio_path}: no samples")

            def source(ch, start, n):
                idx = (start + np.arange(n)) % len(mono)
                return mono[idx]

            return source, float(wav_rate)
        rng = np.random.default_rng(0)

        def source(ch, start, n):
            t = (start + np.arange(n)) / rate
            x = 0.4 * np.sin(2 * np.pi * (2500.0 + 700 * ch) * t)
            return (x + 0.01 * rng.standard_normal(n)).astype(np.float32)

        return source, rate

    def stop():
        nonlocal proc, interface
        if proc is None:
            out("not running")
            return
        # the GUI's Stop tears down immediately
        # (ViewControllerProcessor.swift:116-154); only a finite offline
        # replay gets a BOUNDED grace to finish so detection counts are
        # deterministic — never an unbounded wait (a --realtime source would
        # otherwise block the REPL for the stream's remaining duration)
        if not getattr(args, "realtime", False):
            interface.wait_until_done(timeout=5.0)
        # same compile-sized grace as main(): a cold drain shape on the
        # final chunk must not make 'stop' silently under-report
        proc.drain_pending(timeout=_drain_grace())
        proc.tear_down()
        out(f"stopped; detections per channel: {proc.lane_detections()}")
        proc = None

    out("interactive monitor — load CH NET | start | stop | table | devices | quit")
    while True:
        try:
            line = input_fn("> ")
        except (EOFError, KeyboardInterrupt):
            line = "quit"
        parts = line.strip().split()
        if not parts:
            continue
        cmd = parts[0].lower()
        if cmd == "quit":
            if proc is not None:
                stop()
            if event_fh is not None:
                event_fh.close()
            return 0
        if cmd == "devices":
            devices = list_devices()
            if not devices:
                out("No audio devices registered (simulated sources only).")
            for d in devices:
                out(f"{d.device_id}: {d.device_name} [{d.device_uid}]")
        elif cmd == "load":
            if len(parts) != 3:
                out("usage: load CH NET.txt")
                continue
            try:
                ch = int(parts[1])
                cfg = load_config(parts[2])
            except (ValueError, ConfigError) as e:
                out(f"load failed: {e}")
                continue
            configs[ch] = cfg
            rate = cfg.sampling_rate
            out(f"channel {ch} <- {parts[2]} "
                f"({cfg.sampling_rate:.0f} Hz, threshold {cfg.thresholds[0]})")
        elif cmd == "start":
            if proc is not None:
                out("already running (stop first)")
                continue
            if not configs:
                out("no networks loaded (use: load CH NET.txt)")
                continue
            channels = max(configs) + 1
            try:
                src, device_rate = make_source(args.audio)
            except (OSError, ValueError) as e:
                out(f"start failed: {e}")
                continue
            total = int(args.duration * device_rate)
            interface = SimulatedAudioInput(
                src,
                channels=channels,
                sample_rate=device_rate,
                realtime=args.realtime,
                total_samples=total,
            )
            entries = [
                ProcessorEntry(
                    input_channel=i, output_channel=i, config=configs.get(i),
                    resample_from=device_rate,
                )
                for i in range(channels)
            ]
            out_interface = SimulatedAudioOutput(
                channels=channels, sample_rate=rate
            )
            output = AudioTTLOutput(out_interface)
            try:
                # spec validation happens HERE (bad freq range, layer
                # size mismatch, ...) — a traceback would kill the whole
                # REPL and every loaded row, unlike main()'s guarded path
                proc = Processor(
                    interface, entries, output, event_log=event_log
                )
                proc.set_up()
            except Exception as e:
                out(f"start failed: {type(e).__name__}: {e}")
                # set_up can fail midway (worker thread already started,
                # delegate registered); tear the partial Processor down or
                # the orphaned worker spins for the rest of the session
                if proc is not None:
                    try:
                        proc.tear_down()
                    except Exception:
                        pass
                proc = None
                continue
            out(f"running: {len(proc.entries)} detector(s) over "
                f"{channels} channel(s)")
        elif cmd == "stop":
            stop()
        elif cmd == "table":
            if proc is None:
                out("not running")
                continue
            out(
                f"{'chan':>4} {'in RMS':>10} {'max out':>10} "
                f"{'age s':>8} {'drops':>6} {'lost':>6}"
            )
            for e, st in zip(proc.entries, proc.lane_stats()):
                i = e.input_channel
                rms = proc.get_input_for_channel(i) or 0.0
                o = proc.get_output_for_channel(i) or 0.0
                # audio age: seconds since this lane's capture last
                # delivered — a dead/unplugged mic grows here at a glance
                age = st["last_audio_age_s"]
                age_s = f"{age:>8.1f}" if age is not None else f"{'-':>8}"
                # drops counts host-side overflow events; lost sums the
                # samples the DEVICE itself never delivered (xruns)
                out(
                    f"{i:>4} {rms:>10.4f} {o:>10.4f} {age_s} "
                    f"{st['overflows']:>6} {st['capture_lost_samples']:>6}"
                )
        else:
            out(f"unknown command {cmd!r}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="syllable-detector-monitor")
    p.add_argument(
        "--list-devices",
        action="store_true",
        help="List registered audio devices and exit (the menu window's "
        "device pickers, ViewControllerMenu.swift:86-149).",
    )
    p.add_argument(
        "-n",
        "--net",
        action="append",
        default=[],
        help="Network file; repeat to give each channel its own network "
        "(cycled when fewer nets than channels).",
    )
    p.add_argument("-a", "--audio", help="WAV to stream (loops per channel).")
    p.add_argument("--channels", type=int, default=1)
    p.add_argument(
        "--input",
        default="sim",
        metavar="sim|alsa[:DEV]|pulse[:DEV]",
        help="Capture source: 'sim' streams the WAV/synthetic tone through "
        "the simulated device; 'alsa[:DEV]' / 'pulse[:DEV]' capture REAL "
        "audio (the reference's CoreAudio input selection, "
        "ViewControllerMenu.swift:86-149).",
    )
    p.add_argument(
        "--output",
        choices=("audio", "arduino", "arduino-native", "alsa", "pulse"),
        default="audio",
        help="TTL sink: simulated audio/arduino, 'arduino-native' (the "
        "C++ firmware state machine via ctypes), or a REAL alsa/pulse "
        "playback device rendering the TTL waveform.",
    )
    p.add_argument(
        "--batched-drain",
        action="store_true",
        help="Drain ALL channels in one DetectorBank device program per "
        "round (per-channel distinct nets stack per lane) instead "
        "of per-lane drains; lanes group by pipeline geometry, so mixed "
        "geometries batch within each compatible group.",
    )
    p.add_argument(
        "--wire-format",
        choices=("float32", "int16", "mulaw8"),
        default="float32",
        help="Batched-drain host->device wire format: int16 halves the "
        "transfer bytes (capture-exact PCM), mulaw8 quarters them (lossy "
        "opt-in companding, <=2.3%% relative input error — for "
        "bandwidth-bound links). Only meaningful with --batched-drain.",
    )
    p.add_argument(
        "--warm-up",
        action="store_true",
        help="Compile every drain shape BEFORE starting capture, so no "
        "drain waits on a compile (the persistent cache makes later runs "
        "fast). Recommended for live sessions.",
    )
    p.add_argument("--duration", type=float, default=2.0, help="Seconds to run.")
    p.add_argument("--realtime", action="store_true", help="Pace to wall clock.")
    p.add_argument("--refresh", type=float, default=0.1, help="Table refresh (s).")
    p.add_argument(
        "--event-log",
        metavar="PATH",
        help="Append every live detection to PATH as the offline CLI's CSV "
        "(channel,sample,seconds,out0…) with sample-accurate stream "
        "indices — the session leaves the same record an offline re-scan "
        "would.",
    )
    p.add_argument(
        "--interactive",
        action="store_true",
        help="REPL control loop: load/start/stop/table (the GUI flow).",
    )
    args = p.parse_args(argv)
    enable_compile_cache()

    if args.interactive:
        return interactive_loop(args)

    if args.list_devices:
        from syllable_detector_tpu.runtime.audio_io import list_devices

        try:  # real hardware (Linux): ALSA PCMs join the registry
            from syllable_detector_tpu.runtime.alsa import register_alsa_devices

            register_alsa_devices()
        except Exception:  # enumeration must never break the listing
            pass
        try:  # daemon-routed audio: PulseAudio default source/sink
            from syllable_detector_tpu.runtime.pulse import register_pulse_devices

            register_pulse_devices()
        except Exception:
            pass
        devices = list_devices()
        if not devices:
            print("No audio devices registered (simulated sources only).")
        for d in devices:
            print(
                f"{d.device_id}: {d.device_name} [{d.device_uid}] "
                f"in={d.streams_input} out={d.streams_output} "
                f"rate={d.sample_rate_input}"
            )
        return 0

    if not args.net:
        p.error("the following arguments are required: -n/--net")

    try:
        configs = [load_config(n) for n in args.net]
    except ConfigError as e:
        print(f"Unable to load the network configuration: {e}", file=sys.stderr)
        return 1
    config = configs[0]

    rate = config.sampling_rate
    device_rate = rate  # the simulated device's sample rate

    kind, _, dev_name = args.input.partition(":")
    if kind in ("alsa", "pulse"):
        # real capture hardware: the lane resampler handles any rate
        # mismatch; the stream runs until --duration wall time
        try:
            if kind == "alsa":
                from syllable_detector_tpu.runtime.alsa import AlsaAudioInput

                interface = AlsaAudioInput(
                    device=dev_name or "default", channels=args.channels,
                    sample_rate=rate,
                )
            else:
                from syllable_detector_tpu.runtime.pulse import PulseAudioInput

                interface = PulseAudioInput(
                    device=dev_name or None, channels=args.channels,
                    sample_rate=rate,
                )
        except Exception as e:
            print(f"Unable to open {args.input}: {e}", file=sys.stderr)
            return 1
        args.realtime = True  # real capture is inherently wall-clock paced
        if args.audio:
            # the WAV branch below is sim-only; don't let a user think the
            # file is being streamed into the real capture device
            print(
                f"warning: --audio {args.audio} is ignored with "
                f"--input {args.input} (real capture streams the device)",
                file=sys.stderr,
            )
    elif kind != "sim":
        print(f"Unknown --input {args.input!r}.", file=sys.stderr)
        return 1

    if args.audio and kind == "sim":
        try:
            wav, wav_rate = read_audio(args.audio)
        except (OSError, ValueError) as e:
            print(f"Unable to read {args.audio}: {e}", file=sys.stderr)
            return 1
        mono = np.ascontiguousarray(wav[:, 0])
        if not len(mono):
            print(f"{args.audio}: no samples.", file=sys.stderr)
            return 1
        # stream at the file's own rate; a rate mismatch adds a per-lane
        # resampler below — the GUI's mismatched-device-rate path
        # (ViewControllerProcessor.swift:247-250)
        device_rate = wav_rate

        def source(ch, start, n):
            idx = (start + np.arange(n)) % len(mono)
            return mono[idx]

    elif kind == "sim":
        rng = np.random.default_rng(0)

        def source(ch, start, n):
            t = (start + np.arange(n)) / rate
            x = 0.4 * np.sin(2 * np.pi * (2500.0 + 700 * ch) * t)
            return (x + 0.01 * rng.standard_normal(n)).astype(np.float32)

    if kind == "sim":
        total = int(args.duration * device_rate)
        interface = SimulatedAudioInput(
            source,
            channels=args.channels,
            sample_rate=device_rate,
            realtime=args.realtime,
            total_samples=total,
        )

    # one network per channel, cycling when fewer nets than channels — the
    # processor window's per-row network loading
    # (ViewControllerProcessor.swift:222-276); resample_from adds a lane
    # resampler when the device rate differs from the net rate
    entries = [
        ProcessorEntry(
            input_channel=i,
            output_channel=i,
            config=configs[i % len(configs)],
            resample_from=device_rate,
        )
        for i in range(args.channels)
    ]

    if args.output == "audio":
        out_interface = SimulatedAudioOutput(channels=args.channels, sample_rate=rate)
        output = AudioTTLOutput(out_interface)
    elif args.output in ("arduino", "arduino-native"):
        if args.output == "arduino-native":
            # the device-side state machine as NATIVE C++
            # (native/arduino_firmware.cpp), same wire protocol
            from syllable_detector_tpu.runtime.arduino import (
                NativeFirmwareTransport,
            )

            transport = NativeFirmwareTransport()
        else:
            transport = SimulatedArduinoTransport()
        arduino = ArduinoIO(transport, startup_time=0.0)
        arduino.open()
        output = ArduinoTTLOutput(arduino)
    else:
        # real playback hardware renders the TTL waveform
        # (AudioInterface.swift:13-40)
        try:
            if args.output == "alsa":
                from syllable_detector_tpu.runtime.alsa import (
                    AlsaAudioOutput,
                    alsa_available,
                )

                if not alsa_available():
                    raise RuntimeError("libasound.so.2 is not available")
                out_interface = AlsaAudioOutput(
                    channels=args.channels, sample_rate=rate
                )
            else:
                from syllable_detector_tpu.runtime.pulse import (
                    PulseAudioOutput,
                    pulse_available,
                )

                if not pulse_available():
                    raise RuntimeError("libpulse-simple.so.0 is not available")
                out_interface = PulseAudioOutput(
                    channels=args.channels, sample_rate=rate
                )
            output = AudioTTLOutput(out_interface)
        except Exception as e:
            print(f"Unable to open {args.output} output: {e}", file=sys.stderr)
            return 1

    event_fh = None
    event_log = None
    if args.event_log:
        from syllable_detector_tpu.runtime.processor import csv_event_log

        try:
            event_fh = open(args.event_log, "a")
        except OSError as e:
            print(f"Unable to open --event-log: {e}", file=sys.stderr)
            return 1
        event_log = csv_event_log(event_fh)

    try:
        proc = Processor(
            interface, entries, output, batched=args.batched_drain,
            event_log=event_log, bank_transfer_dtype=args.wire_format,
        )
    except ValueError as e:
        # invalid network configuration surfaced during batched-mode
        # grouping (bad freq range, input-count mismatch, ...); mixed
        # geometries themselves are fine — lanes group per geometry
        print(f"Invalid network configuration: {e}", file=sys.stderr)
        return 1
    # device compiles must not stall the live worker mid-stream; on
    # non-CPU backends give the final drain a compile-sized grace window
    drain_timeout = _drain_grace()
    on_accel = drain_timeout > 10.0

    if args.warm_up:
        print("warming up drain shapes…",
              file=sys.stderr)
        n = proc.warm_up()
        print(f"warm-up compiled {n} drain shapes", file=sys.stderr)
    elif on_accel:
        print(
            "note: running on an accelerator without --warm-up; the first "
            "drain of each new shape compiles on the fly (minutes when the "
            "compile cache is cold).",
            file=sys.stderr,
        )

    try:
        proc.set_up()
    except Exception as e:
        # real device open failures (no card, busy PCM) exit cleanly
        print(f"Unable to start audio: {e}", file=sys.stderr)
        return 1

    last_rms = [0.0] * args.channels
    last_out = [0.0] * args.channels
    print(
        f"{'chan':>4} {'in RMS':>10} {'max out':>10} {'age s':>8} {'lost':>6}"
    )

    def print_table():
        stats = proc.lane_stats()
        by_chan = {s["input_channel"]: s for s in stats}
        cols = []
        for i in range(args.channels):
            rms = proc.get_input_for_channel(i)
            out = proc.get_output_for_channel(i)
            # hold the last value when no new data arrived since the
            # previous refresh (like the GUI's level columns)
            if rms is not None:
                last_rms[i] = rms
            if out is not None:
                last_out[i] = out
            # seconds since the lane's capture last delivered audio: a
            # dead/unplugged mic shows as a growing age (the reference's
            # GUI shows its RMS going quiet instead,
            # ViewControllerProcessor.swift:278-284)
            age = by_chan.get(i, {}).get("last_audio_age_s")
            age_s = f"{age:>8.1f}" if age is not None else f"{'-':>8}"
            lost = by_chan.get(i, {}).get("capture_lost_samples", 0)
            cols.append(
                f"{i:>4} {last_rms[i]:>10.4f} {last_out[i]:>10.4f} {age_s} "
                f"{lost:>6}"
            )
        print("\n".join(cols))

    # wall-clock backstop: realtime runs for --duration by construction;
    # a non-realtime replay streams as fast as it drains, so the cap only
    # guards against a hung source — scale it with the workload instead
    # of a fixed 60 s (which silently truncated long replays) and WARN
    # when it fires
    wall_cap = (
        args.duration
        if args.realtime
        else max(60.0, 10.0 * args.duration) + (drain_timeout if on_accel else 0.0)
    )
    t_end = time.monotonic() + wall_cap
    stream_done = False
    try:
        while time.monotonic() < t_end:
            if interface.wait_until_done(timeout=args.refresh):
                stream_done = True
                break
            print_table()
    except KeyboardInterrupt:
        pass
    if not args.realtime and not stream_done:
        print(
            f"warning: stream not finished after the {wall_cap:.0f} s wall "
            f"cap; results below cover only the audio processed so far",
            file=sys.stderr,
        )
    proc.drain_pending(timeout=drain_timeout)
    print_table()  # final levels after the stream ends
    proc.tear_down()

    print(f"detections per channel: {proc.lane_detections()}")
    if args.output == "audio":
        print(f"TTL events: {len(output.interface.events)}")
    elif args.output == "arduino":
        events = output.arduino.transport.events
        print(f"Arduino events: {len(events)}")
    elif args.output == "arduino-native":
        events = output.arduino.transport.drain_events()
        print(f"Arduino events: {len(events)}")
    if event_fh is not None:
        event_fh.close()
        print(f"event log appended to {args.event_log}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
