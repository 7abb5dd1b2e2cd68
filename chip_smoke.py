"""End-to-end smoke run of the detector on one NVIDIA GPU.

Drives the main paths once, through the entry points users call, at the
reference's example geometry (sample_net.txt: 44.1 kHz, FFT/window 256,
overlap 124, 2-7 kHz = 29 bins, timeRange 10, 290 -> 4 TanSig -> 1
PureLin, l2normalize + mapminmax) and checks each against a plain
reference. All phases share one process, so they share compilations and
the card (a JAX process reserves most of the card's memory).

  1. device   platform, kind, count; the card's name and power limit
  2. corpus   ``cli --batched`` over ~1 h of synthetic audio in a few dozen
              files of heavy-tailed lengths; CSV == the sequential path's
              CSV on a few files; outputs and decisions == the NumPy oracle
  3. colony   ``Processor(batched=True)``: 256 lanes, a distinct net per
              lane, int16 wire, ~20 s paced to the wall clock; event log ==
              the offline CSV of the same audio; no loss, full hop coverage
  4. closed loop  one lane through the per-lane ``Processor`` (Detector),
              32-sample callbacks, audio TTL sink: TTLs fire at the
              oracle's detections (onset -> TTL latencies printed as info)
  5. training ``train`` on synthetic audio, then detect with the exported
              net through ``cli``
  6. drain    the batched XLA drain program at the colony shapes (256 and
              1024 lanes x the 128-hop bucket) and the corpus shape: time
              and parity against the oracle; then the ``gpu`` tests

Every phase prints its parity maxima against its tolerance, its step's
compile time and ``compiled.memory_analysis()``. Any failure exits
non-zero. The last line is ``{"ok": true, "device": {...}}``.

    python chip_smoke.py            # one card
    python chip_smoke.py --cards 4  # only the 4-card paths (see below)

``--cards 4`` runs only: a channel-sharded corpus scan over 4 cards vs the
same scan on one card, and a ``--channel-parallel`` training of 4 distinct
nets vs the single-card run. ``--rehearse`` runs every phase on the CPU at
tiny sizes (a logic check, it measures nothing); without it the script
refuses to run anywhere but on a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax
import numpy as np

# Net outputs lie in [0, 1]; the folded mapminmax gains amplify float32
# rounding ~100x, so 1e-4 absolute is the output contract. Decisions must
# agree except on hops whose output lies within TOL of the threshold.
TOL = 1e-4
# Two trainings of one net on different device layouts agree only as far
# as float32 reassociation lets them: tiny differences compound over the
# epochs. Their detection outputs are held to 1e-3.
TRAIN_TOL = 1e-3


@dataclasses.dataclass(frozen=True)
class Sizes:
    corpus_files: int = 36
    corpus_seconds: float = 3600.0
    corpus_min_s: float = 2.0
    corpus_max_s: float = 300.0
    batch_files: int = 12
    sequential_files: int = 3
    lanes: int = 256
    live_seconds: float = 20.0
    live_chunk: int = 1024
    loop_seconds: float = 4.0
    closed_seconds: float = 4.0
    train_seconds: float = 20.0
    train_epochs: int = 40
    drain_lanes: tuple = (256, 1024)
    drain_oracle_lanes: int = 8
    corpus_shape: tuple = (40, 1 << 22)
    reps: int = 7


REHEARSAL = Sizes(
    corpus_files=4, corpus_seconds=8.0, corpus_min_s=1.0, corpus_max_s=4.0,
    batch_files=2, sequential_files=2, lanes=4, live_seconds=2.0,
    live_chunk=1024, loop_seconds=1.0, closed_seconds=1.0,
    train_seconds=4.0, train_epochs=5, drain_lanes=(8,),
    drain_oracle_lanes=2, corpus_shape=(2, 1 << 16), reps=2,
)


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseFailure(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailure(msg)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def card_line() -> str:
    """The card's name and power limit, read by a child that stays off JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def report_compiled(label: str, jitted, *args, **kwargs) -> None:
    """Compile ``jitted`` for these arguments; print time and memory."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args, **kwargs).compile()
    dt = time.perf_counter() - t0
    log(f"  [{label}] compile {dt:.3f} s; memory {compiled.memory_analysis()}")


def cli_lines(argv) -> list[str]:
    from syllable_detector_tpu.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    check(rc == 0, f"cli {argv[:4]}... exited {rc}")
    return [l for l in buf.getvalue().splitlines() if l]


def parse_rows(lines, headers=True):
    """CSV lines -> {(file, channel, sample): outputs}."""
    rows, current = {}, None
    for line in lines:
        parts = line.split(",")
        if headers and len(parts) == 1:
            current = line
            continue
        rows[(current, int(parts[0]), int(parts[1]))] = np.asarray(
            [float(v) for v in parts[3:]], np.float64
        )
    return rows


def compare_rows(label, got, want, thresholds) -> None:
    """Row-for-row CSV comparison: the same (file, channel, sample) keys,
    outputs within TOL. A row on one side only is allowed when its output
    lies within TOL of the threshold (counted and printed)."""
    err = 0.0
    near = 0
    for key in got.keys() & want.keys():
        err = max(err, float(np.abs(got[key] - want[key]).max()))
    for side in (got.keys() - want.keys(), want.keys() - got.keys()):
        for key in side:
            row = got.get(key, want.get(key))
            thr = np.asarray(thresholds(key[1]), np.float64)
            check(
                float(np.abs(row - thr).min()) <= TOL,
                f"{label}: row {key} on one side only, output {row} is "
                f"not within {TOL} of the threshold",
            )
            near += 1
    check(err <= TOL, f"{label}: max output error {err:.3e} > {TOL}")
    log(f"  [{label}] {len(want)} rows; max |err| {err:.3e} (tol {TOL}); "
        f"{near} near-threshold rows on one side only")


def compare_outputs(label, got, want, threshold, tol=TOL) -> float:
    """Raw outputs vs the oracle: max error within ``tol``, decisions equal
    except within ``tol`` of the threshold."""
    check(got.shape == want.shape, f"{label}: shape {got.shape} != {want.shape}")
    err = float(np.abs(got - want).max()) if got.size else 0.0
    flips = (got >= threshold) != (want >= threshold)
    near = np.abs(want - threshold) <= tol
    check(not np.any(flips & ~near), f"{label}: decisions differ away "
          "from the threshold")
    check(err <= tol, f"{label}: max |err| {err:.3e} > {tol}")
    log(f"  [{label}] {got.size} outputs; max |err| {err:.3e} (tol {tol}); "
        f"{int(np.sum(flips))} decision flips, {int(np.sum(near))} "
        f"outputs within tol of the threshold")
    return err


def quantize_int16(x):
    """Samples on the int16 wire's grid, so the wire round trip is exact."""
    return (np.rint(np.clip(x, -1.0, 1.0) * 32767.0) / 32767.0).astype(
        np.float32
    )


def lane_nets(cfg, n, seed, tmp):
    """``n`` distinct nets of ``cfg``'s geometry, derived from the seed,
    written as net files -> (paths, configs)."""
    from syllable_detector_tpu.config.model_format import load_config, save_config

    rng = np.random.default_rng(seed)
    paths, cfgs = [], []
    for k in range(n):
        layers = [
            dataclasses.replace(
                l,
                weights=(l.weights * (1 + 0.05 * rng.standard_normal(
                    l.weights.shape))).astype(np.float32),
            )
            for l in cfg.layers
        ]
        path = os.path.join(tmp, f"lane{k}.txt")
        save_config(dataclasses.replace(cfg, layers=layers), path)
        paths.append(path)
        cfgs.append(load_config(path))
    return paths, cfgs


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(rehearse: bool):
    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    log(f"device: {json.dumps(info)}")
    if rehearse:
        check(dev.platform == "cpu", "--rehearse is for the CPU only")
        log("card: none (CPU rehearsal; nothing here is a measurement)")
    else:
        log("card (nvidia-smi name, power.limit):")
        log(card_line())
    return info


def make_corpus(sz: Sizes, seed: int, tmp: str):
    """A few dozen int16 WAVs of synth chirp audio with heavy-tailed
    (lognormal) lengths summing to ~sz.corpus_seconds."""
    from syllable_detector_tpu.utils.synth import make_labeled_audio
    from syllable_detector_tpu.utils.wav import read_audio, write_wav

    rng = np.random.default_rng(seed)
    lengths = rng.lognormal(0.0, 1.2, sz.corpus_files)
    lengths = np.clip(
        lengths * sz.corpus_seconds / lengths.sum(),
        sz.corpus_min_s, sz.corpus_max_s,
    )
    paths, streams = [], []
    for i, secs in enumerate(lengths):
        x, _ = make_labeled_audio(seconds=float(secs), seed=seed * 1000 + i)
        x = quantize_int16(x * rng.uniform(0.3, 1.2))
        path = os.path.join(tmp, f"corpus{i:03d}.wav")
        write_wav(path, x, 44100, dtype="int16")
        paths.append(path)
        streams.append(read_audio(path)[0][:, 0])  # what the cli reads
    log(f"  corpus: {len(paths)} files, {lengths.sum():.1f} s of audio, "
        f"{lengths.min():.1f}-{lengths.max():.1f} s each")
    return paths, streams


def phase_corpus(sz: Sizes, seed: int, net: str, tmp: str) -> None:
    import reference_impl as ref
    from syllable_detector_tpu.config.model_format import load_config
    from syllable_detector_tpu.corpus import _batch, _bucket
    from syllable_detector_tpu.models.detector import detector_spec_from_config

    cfg = load_config(net)
    spec, params = detector_spec_from_config(cfg)
    paths, streams = make_corpus(sz, seed, tmp)

    t0 = time.perf_counter()
    batched = cli_lines(["-n", net, "--batched", "--batch-files",
                         str(sz.batch_files)] + sum([["-a", p] for p in paths], []))
    dt = time.perf_counter() - t0
    audio_s = sum(len(s) for s in streams) / cfg.sampling_rate
    log(f"  cli --batched: {len(batched)} lines in {dt:.2f} s wall "
        f"({audio_s / dt:.0f} audio-s/s, compiles included)")
    group = len(paths[: sz.batch_files])
    bucket = _bucket(max(len(s) for s in streams[: sz.batch_files]))
    report_compiled(
        "corpus group", _batch, spec, params,
        jax.ShapeDtypeStruct((group, bucket), np.float32), "matmul",
    )

    # the sequential path on a few files gives the same CSV
    few = sorted(range(len(paths)), key=lambda i: len(streams[i]))[
        : sz.sequential_files
    ]
    few_args = sum([["-a", paths[i]] for i in few], [])
    seq = cli_lines(["-n", net] + few_args)
    bat = cli_lines(["-n", net, "--batched"] + few_args)
    thr = lambda ch: cfg.thresholds
    compare_rows("sequential vs batched CSV", parse_rows(bat), parse_rows(seq), thr)

    # the independent NumPy oracle over the whole corpus
    want_lines, oracle_rows = [], {}
    t0 = time.perf_counter()
    for p, x in zip(paths, streams):
        want_lines.append(p)
        want_lines += ref.cli_lines(cfg, x)
    log(f"  oracle over {audio_s:.0f} s of audio took "
        f"{time.perf_counter() - t0:.1f} s")
    compare_rows("batched CSV vs oracle", parse_rows(batched),
                 parse_rows(want_lines), thr)
    from syllable_detector_tpu.corpus import scan_corpus

    short = few[: 2]
    outs = scan_corpus(cfg, [streams[i] for i in short])
    for i, o in zip(short, outs):
        compare_outputs(f"outputs {os.path.basename(paths[i])}", o,
                        ref.detect_offline(cfg, streams[i]), cfg.thresholds[0])


def phase_colony(sz: Sizes, seed: int, net: str, tmp: str) -> None:
    """Live batched Processor as ``monitor --batched-drain --wire-format
    int16 --realtime --warm-up`` builds it, with distinct audio and a
    distinct net per lane."""
    from syllable_detector_tpu.config.model_format import load_config
    from syllable_detector_tpu.corpus import scan_corpus
    from syllable_detector_tpu.models.detector import detector_spec_from_config
    from syllable_detector_tpu.models.detector_bank import _bank_program
    from syllable_detector_tpu.ops.stft import num_frames
    from syllable_detector_tpu.runtime.audio_io import SimulatedAudioInput
    from syllable_detector_tpu.runtime.processor import (
        CallbackOutput,
        Processor,
        ProcessorEntry,
    )
    from syllable_detector_tpu.utils.synth import make_labeled_audio

    cfg = load_config(net)
    _, cfgs = lane_nets(cfg, sz.lanes, seed + 1, tmp)
    rate = cfg.sampling_rate
    loop_n = int(sz.loop_seconds * rate) // sz.live_chunk * sz.live_chunk
    rng = np.random.default_rng(seed + 2)
    loops = np.stack([
        quantize_int16(
            make_labeled_audio(seconds=loop_n / rate + 0.01,
                               seed=seed * 7919 + k)[0][:loop_n]
            * rng.uniform(0.3, 1.2)
        )
        for k in range(sz.lanes)
    ])

    def source(ch, start, n):
        o = start % loop_n
        return loops[ch, o : o + n]

    total = int(sz.live_seconds * rate)
    interface = SimulatedAudioInput(
        source, channels=sz.lanes, sample_rate=rate,
        frame_size=sz.live_chunk, realtime=True, total_samples=total,
    )
    events = []
    spec = detector_spec_from_config(cfg)[0]
    bucket = 128
    proc = Processor(
        interface,
        [ProcessorEntry(i, i, c) for i, c in enumerate(cfgs)],
        CallbackOutput(lambda i, e, s: None),
        ring_seconds=10.0,
        batched=True,
        event_log=lambda ch, s, t, o: events.append((ch, s, tuple(o))),
        bank_buffer_seconds=30.0,
        bank_buckets=(bucket,),
        bank_transfer_dtype="int16",
        bank_min_drain_hops=bucket,
        drain_interval=bucket * spec.hop / rate,
    )
    bank = proc._bank
    t0 = time.perf_counter()
    proc.warm_up()
    log(f"  warm-up {time.perf_counter() - t0:.2f} s")
    need = (bucket + spec.time_range - 2) * spec.hop + spec.window_length
    from syllable_detector_tpu.models.neural_net import stack_params

    report_compiled(
        "colony drain", _bank_program, spec, "int16",
        stack_params(bank.params_list),
        jax.ShapeDtypeStruct((sz.lanes, need), np.int16),
    )
    t0 = time.perf_counter()
    proc.set_up()
    done = interface.wait_until_done(timeout=sz.live_seconds * 3 + 120)
    feed = time.perf_counter() - t0
    proc.drain_pending(timeout=120)
    proc.tear_down()
    bank.drain(flush=True)  # end of stream: the last sub-bucket tails
    check(done, "capture did not finish")
    delivered = interface.samples_delivered
    stats = proc.lane_stats()
    losses = sum(s["dropped_samples"] for s in stats) + sum(
        s["capture_lost_samples"] for s in stats)
    f = num_frames(delivered, spec.window_length, spec.window_overlap)
    expected = sz.lanes * max(0, f - spec.time_range + 1)
    coverage = int(np.sum(bank.hops_emitted)) / expected
    log(f"  {sz.lanes} lanes x {delivered / rate:.1f} s in {feed:.2f} s wall; "
        f"capture losses {losses} samples, drain errors {proc.drain_errors}, "
        f"hop coverage {coverage * 100:.4f}%")
    check(losses == 0 and proc.drain_errors == 0, "live run lost audio")
    check(coverage == 1.0, f"hop coverage {coverage} != 1")

    # offline CSV of the same audio (live criterion: output 0 >= threshold)
    streams = [np.resize(loops[k], delivered) for k in range(sz.lanes)]
    outs = scan_corpus(cfg, streams, lane_configs=cfgs)
    want = {}
    for k, o in enumerate(outs):
        hit = o[:, 0] >= np.float32(cfgs[k].thresholds[0])
        for j in np.flatnonzero(hit):
            want[(None, k, cfg.first_output_sample + int(j) * spec.hop)] = (
                o[j].astype(np.float64))
    got = {(None, ch, s): np.asarray(o, np.float64) for ch, s, o in events}
    # rows the final flush evaluated never reach the event log: drop the
    # offline rows past each lane's last logged-drain hop
    tail0 = {k: cfg.first_output_sample
             + (int(bank.hops_emitted[k]) - int(bank.last_counts[k])) * spec.hop
             for k in range(sz.lanes)}
    want = {key: v for key, v in want.items() if key[2] < tail0[key[1]]}
    compare_rows("live event log vs offline", got, want,
                 lambda ch: cfgs[ch].thresholds)


class _TimedTTL:
    """Audio TTL sink that stamps each pulse on the monotonic clock."""

    def __init__(self):
        self.pulses = []

    def initialize_audio(self):
        pass

    def tear_down_audio(self):
        pass

    def create_high_output(self, channel, duration):
        self.pulses.append(time.monotonic())


def phase_closed_loop(sz: Sizes, seed: int, net: str) -> None:
    import reference_impl as ref
    from syllable_detector_tpu.config.model_format import load_config
    from syllable_detector_tpu.models import detector as detector_mod
    from syllable_detector_tpu.runtime.audio_io import SimulatedAudioInput
    from syllable_detector_tpu.runtime.processor import (
        AudioTTLOutput,
        Processor,
        ProcessorEntry,
    )
    from syllable_detector_tpu.utils.synth import make_labeled_audio

    cfg = load_config(net)
    rate = cfg.sampling_rate
    total = int(sz.closed_seconds * rate) // 32 * 32
    x, _ = make_labeled_audio(seconds=total / rate + 0.01, seed=seed + 3)
    x = x[:total].astype(np.float32)
    stamps = {}

    def source(ch, start, n):
        stamps[start] = time.monotonic()
        return x[start : start + n]

    interface = SimulatedAudioInput(
        source, channels=1, sample_rate=rate, frame_size=32, realtime=True,
        total_samples=total,
    )
    ttl = _TimedTTL()
    events = []
    proc = Processor(
        interface, [ProcessorEntry(0, 0, cfg)], AudioTTLOutput(ttl),
        event_log=lambda ch, s, t, o: events.append(s),
    )
    proc.warm_up()  # every drain bucket, as `monitor --warm-up` does
    spec = proc._lanes[0].detector.spec
    det = proc._lanes[0].detector
    report_compiled(
        "closed-loop drain", detector_mod._drain_step, spec, det.params,
        jax.ShapeDtypeStruct(
            ((8 - 1) * spec.hop + spec.window_length,), np.float32),
        jax.ShapeDtypeStruct((spec.history, spec.n_bins), np.float32),
        jax.ShapeDtypeStruct((), np.int32), 8, "matmul",
    )
    proc.set_up()
    check(interface.wait_until_done(timeout=sz.closed_seconds * 3 + 60),
          "closed-loop capture did not finish")
    proc.drain_pending(timeout=60)
    proc.tear_down()

    outs = ref.detect_offline(cfg, x)
    thr = np.float32(cfg.thresholds[0])
    samples = cfg.first_output_sample + np.arange(len(outs)) * spec.hop
    hits = samples[outs[:, 0] >= thr]
    near = samples[np.abs(outs[:, 0] - thr) <= TOL]
    got = set(events)
    odd = got.symmetric_difference(set(int(s) for s in hits))
    check(odd <= set(int(s) for s in near),
          f"closed loop: event log differs from the oracle at {sorted(odd)[:5]}")
    # each detection's TTL: the first pulse after the callback that
    # delivered the detection's last sample
    lat = []
    pulses = np.asarray(ttl.pulses)
    for s in hits:
        start = (int(s) - 1) // 32 * 32
        t_cap = stamps.get(start)
        later = pulses[pulses >= t_cap] if t_cap is not None else []
        check(len(later) > 0, f"no TTL after the detection at sample {s}")
        lat.append(later[0] - t_cap)
    check(len(hits) > 0, "closed-loop audio produced no detections")
    lat = np.asarray(lat) * 1e3
    log(f"  {len(hits)} detections, {len(pulses)} TTL pulses; onset->TTL "
        f"latency p50 {np.percentile(lat, 50):.3f} ms, p99 "
        f"{np.percentile(lat, 99):.3f} ms, max {lat.max():.3f} ms (info)")


def train_files(sz: Sizes, seed: int, tmp: str, n: int = 1):
    from syllable_detector_tpu.utils.synth import make_labeled_audio
    from syllable_detector_tpu.utils.wav import write_wav

    args = []
    for k in range(n):
        x, intervals = make_labeled_audio(seconds=sz.train_seconds,
                                          seed=seed + 10 + k)
        wav = os.path.join(tmp, f"train{k}.wav")
        labels = os.path.join(tmp, f"train{k}.csv")
        write_wav(wav, x, 44100, dtype="float32")
        with open(labels, "w") as fh:
            fh.writelines(f"{a},{b}\n" for a, b in intervals)
        args += ["-a", wav, "-l", labels]
    return args


def phase_training(sz: Sizes, seed: int, tmp: str) -> None:
    import optax

    import reference_impl as ref
    from syllable_detector_tpu.config.model_format import load_config
    from syllable_detector_tpu.models.detector import detector_spec_from_config
    from syllable_detector_tpu.train import main as train_main
    from syllable_detector_tpu.training.trainer import train_step
    from syllable_detector_tpu.utils.synth import make_labeled_audio
    from syllable_detector_tpu.utils.wav import write_wav

    out = os.path.join(tmp, "trained.txt")
    t0 = time.perf_counter()
    rc = train_main(train_files(sz, seed, tmp) + [
        "-o", out, "--epochs", str(sz.train_epochs), "--seed", str(seed),
        "--quiet"])
    check(rc == 0, f"train exited {rc}")
    log(f"  train: {sz.train_epochs} epochs in {time.perf_counter() - t0:.2f} s")
    cfg = load_config(out)
    spec, params = detector_spec_from_config(cfg)
    batch = 256
    report_compiled(
        "train step", train_step, spec.net, params,
        optax.adam(1e-3).init(params["layers"]),
        jax.ShapeDtypeStruct((batch, spec.net.inputs), np.float32),
        jax.ShapeDtypeStruct((batch,), np.float32),
    )
    x, _ = make_labeled_audio(seconds=4.0, seed=seed + 99)
    wav = os.path.join(tmp, "heldout.wav")
    write_wav(wav, x, 44100, dtype="float32")
    got = cli_lines(["-n", out, "-a", wav])
    check(len(got) > 0, "the trained net detects nothing on held-out audio")
    compare_rows("trained net via cli vs oracle", parse_rows(got, False),
                 parse_rows(ref.cli_lines(cfg, x), False),
                 lambda ch: cfg.thresholds)


def median_seconds(fn, reps):
    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def phase_drain(sz: Sizes, seed: int, net: str, tmp: str, rehearse: bool) -> None:
    import reference_impl as ref
    from syllable_detector_tpu.config.model_format import load_config
    from syllable_detector_tpu.corpus import _batch
    from syllable_detector_tpu.models.detector import detector_spec_from_config
    from syllable_detector_tpu.models.detector_bank import _bank_program
    from syllable_detector_tpu.models.neural_net import stack_params

    cfg = load_config(net)
    spec = detector_spec_from_config(cfg)[0]
    rng = np.random.default_rng(seed + 5)
    bucket = 128
    need = (bucket + spec.time_range - 2) * spec.hop + spec.window_length
    for lanes in sz.drain_lanes:
        _, cfgs = lane_nets(cfg, lanes, seed + lanes, tmp)
        stacked = stack_params([detector_spec_from_config(c)[1] for c in cfgs])
        x = quantize_int16(0.3 * rng.standard_normal((lanes, need)))
        codes = jax.device_put(np.rint(x * 32767).astype(np.int16))
        report_compiled(f"drain {lanes} lanes", _bank_program, spec, "int16",
                        stacked, codes)
        t = median_seconds(lambda: _bank_program(spec, "int16", stacked, codes),
                           sz.reps)
        outs = np.asarray(_bank_program(spec, "int16", stacked, codes))
        log(f"  drain {lanes} lanes x {bucket}-hop bucket: {t * 1e3:.3f} ms "
            f"(median of {sz.reps})")
        for k in range(sz.drain_oracle_lanes):
            compare_outputs(f"drain lane {k}/{lanes}", outs[k],
                            ref.detect_offline(cfgs[k], x[k]),
                            cfgs[k].thresholds[0])

    lanes, n = sz.corpus_shape
    spec, params = detector_spec_from_config(cfg)
    x = quantize_int16(0.3 * rng.standard_normal((lanes, n)))
    xs = jax.device_put(x)
    report_compiled("corpus shape", _batch, spec, params, xs, "matmul")
    t = median_seconds(lambda: _batch(spec, params, xs, "matmul"), sz.reps)
    outs = np.asarray(_batch(spec, params, xs, "matmul"))
    log(f"  corpus {lanes} x {n} samples: {t * 1e3:.3f} ms "
        f"(median of {sz.reps}), {outs.shape[0] * outs.shape[1] / t:.4g} windows/s")
    compare_outputs("corpus lane 0", outs[0], ref.detect_offline(cfg, x[0]),
                    cfg.thresholds[0])

    if not rehearse:  # the card-only tests
        import pytest

        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          os.path.join(ROOT, "tests", "test_gpu.py")])
        check(rc == 0, f"gpu tests exited {rc}")


def phase_four_cards(sz: Sizes, seed: int, net: str, tmp: str) -> None:
    from syllable_detector_tpu.config.model_format import load_config
    from syllable_detector_tpu.corpus import scan_corpus
    from syllable_detector_tpu.parallel.mesh import make_mesh
    from syllable_detector_tpu.train import main as train_main

    check(len(jax.devices()) >= 4, f"needs 4 devices, found {jax.devices()}")
    cfg = load_config(net)
    paths, streams = make_corpus(sz, seed, tmp)
    _, cfgs = lane_nets(cfg, len(streams), seed + 1, tmp)
    t0 = time.perf_counter()
    sharded = scan_corpus(cfg, streams, mesh=make_mesh(4), lane_configs=cfgs)
    t_sh = time.perf_counter() - t0
    t0 = time.perf_counter()
    with jax.default_matmul_precision("highest"):  # the reference side
        single = scan_corpus(cfg, streams, lane_configs=cfgs)
    t_one = time.perf_counter() - t0
    log(f"  corpus scan: 4 cards {t_sh:.2f} s, 1 card {t_one:.2f} s "
        "(wall, compiles included)")
    for k, (a, b) in enumerate(zip(sharded, single)):
        compare_outputs(f"sharded lane {k}", a, b, cfgs[k].thresholds[0])

    args = train_files(sz, seed, tmp, n=4)
    common = ["--epochs", str(sz.train_epochs), "--seed", str(seed), "--quiet"]
    rc = train_main(args + ["-o", os.path.join(tmp, "par{ch}.txt"),
                            "--channel-parallel"] + common)
    check(rc == 0, f"--channel-parallel training exited {rc}")
    rc = train_main(args + ["-o", os.path.join(tmp, "one{ch}.txt")] + common)
    check(rc == 0, f"single-card ensemble training exited {rc}")
    from syllable_detector_tpu.models.detector import (
        detector_spec_from_config,
        offline_outputs,
    )

    x = streams[0][: 44100 * 4]
    for ch in range(4):
        a = load_config(os.path.join(tmp, f"par{ch}.txt"))
        b = load_config(os.path.join(tmp, f"one{ch}.txt"))
        oa = np.asarray(offline_outputs(*detector_spec_from_config(a), x))
        ob = np.asarray(offline_outputs(*detector_spec_from_config(b), x))
        compare_outputs(f"channel-parallel net {ch}", oa, ob,
                        b.thresholds[0], tol=TRAIN_TOL)


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cards", type=int, choices=(1, 4), default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--net", default=os.path.join(ROOT, "sample_net.txt"))
    p.add_argument("--rehearse", action="store_true",
                   help="CPU logic check at tiny sizes (measures nothing)")
    args = p.parse_args(argv)

    from syllable_detector_tpu.utils.compile_cache import enable_compile_cache

    if args.rehearse:
        if jax.default_backend() != "cpu":
            print("--rehearse runs on the CPU only", file=sys.stderr)
            return 2
    elif jax.default_backend() != "gpu":
        print(f"chip_smoke.py needs an NVIDIA GPU; JAX found {jax.devices()}",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    sz = REHEARSAL if args.rehearse else Sizes()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        info = phase_device(args.rehearse)
        if args.cards == 4:
            phases = [("four cards",
                       lambda: phase_four_cards(sz, args.seed, args.net, tmp))]
        else:
            phases = [
                ("corpus", lambda: phase_corpus(sz, args.seed, args.net, tmp)),
                ("colony", lambda: phase_colony(sz, args.seed, args.net, tmp)),
                ("closed loop",
                 lambda: phase_closed_loop(sz, args.seed, args.net)),
                ("training", lambda: phase_training(sz, args.seed, tmp)),
                ("drain", lambda: phase_drain(sz, args.seed, args.net, tmp,
                                              args.rehearse)),
            ]
        for name, run in phases:
            t0 = time.perf_counter()
            log(f"phase {name}:")
            run()
            log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
