"""Live end-to-end scale run on the GPU.

Drives the ACTUAL live pipeline — wall-clock simulated capture ->
Processor.receive_audio fan-out -> native ring -> worker ->
DetectorBank batched drains (one device program each) -> event log —
at production rates, sweeping lane counts to find the SUSTAINED maximum
(zero audio loss, bounded backlog, detection throughput == realtime).
This converts the kernel-throughput "realtime channels" arithmetic into a
measured system capability, the same thing the reference's numbers mean
(reference: SyllableDetector/Processor.swift:102-149 — its capacity is
genuinely end-to-end on its RT thread).

Per swept point it reports the host/device split: capture fan-out cost, bank staging (host assembly), device
transfer+compute per drain, and the wire byte rate vs the link's
measured ceiling — so the binding bottleneck is NAMED, not guessed.

Operating profile per point (all CLI-overridable):
  * drain batching window (Processor drain_interval) — transfer-bound
    deployments coalesce capture chunks so the per-drain context resend
    amortizes toward the raw realtime byte rate;
  * pinned bucket ladder (bank_buckets=(128,)) — ONE compiled drain
    shape per lane count (warm_up compiles it before the clock starts);
  * min_drain_hops=128 — sub-bucket tails wait for the next window
    instead of paying a whole bucket-shaped transfer;
  * optional int16 wire (bank_transfer_dtype) — halves transfer bytes;
    mulaw8 quarters them (lossy opt-in companding tier)
    (capture-native PCM, dequantized on device).

Results append to scripts/live_scale_results.jsonl (one JSON per point).

Run: python scripts/live_scale_hw.py --lanes 256,1024,2048 --seconds 60
     python scripts/live_scale_hw.py --lanes 2048,4096 --wire int16
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def pct(xs, p):
    return float(np.percentile(np.asarray(xs), p)) if len(xs) else 0.0


def make_chirp(rate, seconds, rng):
    """Audio that periodically triggers the sample net (2-7 kHz chirp
    bursts over noise) so detections/event-log work is exercised."""
    n = int(seconds * rate)
    x = 0.02 * rng.standard_normal(n).astype(np.float32)
    burst = int(0.15 * rate)
    ph = 2 * np.pi * np.cumsum(np.linspace(2000.0, 7000.0, burst)) / rate
    tone = (0.5 * np.sin(ph)).astype(np.float32)
    for start in range(int(0.5 * rate), n - burst, int(1.0 * rate)):
        x[start : start + burst] += tone
    return np.clip(x, -1.0, 1.0)


def run_point(
    cfg_path,
    lanes,
    seconds,
    chunk,
    interval,
    buckets,
    min_hops,
    wire,
    buffer_seconds,
    events_path=None,
    allow_cpu=False,
    ring_seconds=None,
    bank_patch=None,
    start_gate=None,
    label=None,
):
    """One swept point. ``bank_patch(bank)`` (optional) rewires the bank
    right after construction — scripts/live_multiproc_hw.py routes
    ``_wire_outputs`` to the parent device server with it, reusing this
    whole pipeline+metrics body per worker process. ``start_gate()``
    (optional) blocks after warm-up and before the wall clock starts, so
    multiple workers align their feeds on a barrier. ``label`` prefixes
    log lines (defaults to the lane count)."""
    import jax

    from syllable_detector_tpu.config.model_format import load_config
    from syllable_detector_tpu.runtime.audio_io import SimulatedAudioInput
    from syllable_detector_tpu.utils.compile_cache import enable_compile_cache
    from syllable_detector_tpu.runtime.processor import (
        CallbackOutput,
        Processor,
        ProcessorEntry,
    )

    enable_compile_cache()
    if not allow_cpu:
        # only touch jax.devices() when the GPU assertion is wanted: a
        # multiproc WORKER must never initialize a device backend (the
        # parent owns the card; allow_cpu=True there skips this probe)
        dev = jax.devices()[0]
        assert dev.platform != "cpu", f"needs a GPU, got {dev}"
    cfg = load_config(cfg_path)
    rate = float(cfg.sampling_rate)
    rng = np.random.default_rng(7)

    # audio: lane 0 carries detection-triggering chirp bursts; the rest
    # low-level noise (a realistic mostly-quiet colony). Buffers sized a
    # whole number of chunks so wall-clock ticks slice without wrapping.
    loop_s = max(4.0, 256 * chunk / rate)
    loop_n = int(np.ceil(loop_s * rate / chunk)) * chunk
    noise = (0.02 * rng.standard_normal(loop_n)).astype(np.float32)
    chirp = make_chirp(rate, loop_n / rate, rng)[:loop_n]

    tick_t = []  # wall time at each ch-0 source call

    def source(ch, start, n):
        if ch == 0:
            tick_t.append(time.monotonic())
            buf = chirp
        else:
            buf = noise
        o = start % loop_n
        return buf[o : o + n]

    total = int(seconds * rate)
    interface = SimulatedAudioInput(
        source,
        channels=lanes,
        sample_rate=rate,
        frame_size=chunk,
        realtime=True,
        total_samples=total,
    )

    entries = [
        ProcessorEntry(input_channel=i, output_channel=i, config=cfg)
        for i in range(lanes)
    ]
    n_events = [0]
    ev_fh = open(events_path, "w") if events_path else None

    def event_sink(channel, sample, secs, outputs):
        n_events[0] += 1
        if ev_fh is not None:
            ev_fh.write(f"{channel},{sample},{secs}\n")

    t0 = time.monotonic()
    proc = Processor(
        interface,
        entries,
        CallbackOutput(lambda i, e, s: None),
        # stall insurance: the ring must cover the worst device stall
        # while the drain's steady-state headroom catches back up
        ring_seconds=(
            ring_seconds
            if ring_seconds is not None
            else max(2.0, 4 * interval if interval else 2.0)
        ),
        batched=True,
        event_log=event_sink,
        bank_buffer_seconds=buffer_seconds,
        bank_buckets=buckets,
        bank_transfer_dtype=wire,
        bank_min_drain_hops=min_hops,
        drain_interval=interval,
    )
    t_build = time.monotonic() - t0
    bank = proc._bank
    assert bank is not None
    if bank_patch is not None:
        bank_patch(bank)

    # --- instrumentation -------------------------------------------------
    drain_wall, dev_wall, wire_bytes = [], [], [0]
    orig_wire = bank._wire_outputs

    def timed_wire(xs_np):
        wire_bytes[0] += xs_np.nbytes
        t = time.monotonic()
        out = orig_wire(xs_np)
        jax.block_until_ready(out)
        dev_wall.append(time.monotonic() - t)
        return out

    bank._wire_outputs = timed_wire
    orig_drain = bank.drain
    backlog_hw = [0]  # high-water of bank backlog just before each drain

    def timed_drain(flush=False):
        backlog_hw[0] = max(
            backlog_hw[0],
            max(bank.buffered_samples(i) for i in range(lanes)),
        )
        t = time.monotonic()
        out = orig_drain(flush=flush)
        drain_wall.append(time.monotonic() - t)
        return out

    bank.drain = timed_drain

    feed_busy = [0.0]
    orig_recv = proc.receive_audio
    orig_recv_block = proc.receive_audio_block

    def timed_recv(iface, ch, data):
        t = time.monotonic()
        orig_recv(iface, ch, data)
        feed_busy[0] += time.monotonic() - t

    def timed_recv_block(iface, block):
        t = time.monotonic()
        orig_recv_block(iface, block)
        feed_busy[0] += time.monotonic() - t

    interface.delegate = timed_recv
    interface.block_delegate = timed_recv_block

    # --- warm the drain shapes BEFORE the clock starts -------------------
    t0 = time.monotonic()
    n_shapes = proc.warm_up()
    t_warm = time.monotonic() - t0
    log(
        f"[{label or f'{lanes} lanes'}] setup {t_build:.1f}s, warmed {n_shapes} drain "
        f"shape(s) in {t_warm:.1f}s (wire={wire}, buckets={buckets}, "
        f"min_hops={min_hops}, interval={interval}s, chunk={chunk})"
    )

    # --- run --------------------------------------------------------------
    if start_gate is not None:
        start_gate()
    t_run0 = time.monotonic()
    proc.set_up()
    done = interface.wait_until_done(timeout=seconds * 3 + 120)
    t_feed = time.monotonic() - t_run0
    proc.drain_pending(timeout=180)  # a late stall can leave a deep backlog
    # end-of-stream: evaluate the last sub-threshold tails too
    bank.drain(flush=True)
    proc.tear_down()
    if ev_fh is not None:
        ev_fh.close()

    # --- metrics ------------------------------------------------------------
    stats = proc.lane_stats()
    ring_over = sum(s["overflows"] for s in stats)
    ring_drop = sum(s["dropped_samples"] for s in stats)
    bank_over = sum(bank.overflows)
    bank_drop = sum(bank.dropped_samples)
    detections = sum(proc.lane_detections())
    hops = int(np.sum(bank.hops_emitted))
    delivered = interface.samples_delivered
    # expected evaluable hops for a `delivered`-sample stream, per lane
    from syllable_detector_tpu.models.detector import detector_spec_from_config
    from syllable_detector_tpu.ops.stft import num_frames

    spec, _ = detector_spec_from_config(cfg)
    f = num_frames(delivered, spec.window_length, spec.window_overlap)
    exp_per_lane = max(0, f - spec.time_range + 1)
    coverage = hops / (lanes * exp_per_lane) if exp_per_lane else 1.0

    ticks = np.asarray(tick_t)
    ideal = ticks[0] + np.arange(len(ticks)) * (chunk / rate)
    late = ticks - ideal
    backlog = max(bank.buffered_samples(i) for i in range(lanes))

    drain_host = [
        max(0.0, d - v) for d, v in zip(drain_wall, dev_wall)
    ] if len(drain_wall) == len(dev_wall) else []
    realtime_mib = lanes * rate * {"int16": 2, "mulaw8": 1}.get(wire, 4) / 2**20
    wire_mib_s = wire_bytes[0] / 2**20 / t_feed

    # sustained = the lossless stall-insured contract: nothing dropped,
    # full hop coverage, capture averaged realtime over the whole run,
    # and the backlog high-water stayed within half the buffer (a stall
    # twice as long as the worst observed would still not lose audio).
    # `strict` additionally demands smooth capture ticks (p99 < 250 ms) —
    # hard-realtime smoothness with no transient host lag at all.
    lossless = (
        done
        and ring_over == 0
        and bank_over == 0
        and proc.drain_errors == 0
        and coverage >= 0.999
    )
    sustained = (
        lossless
        and t_feed <= seconds * 1.02
        and backlog_hw[0] <= buffer_seconds * rate * 0.5
    )
    strict = sustained and pct(late, 99) < 0.25

    r = {
        "lanes": lanes,
        "seconds": seconds,
        "chunk": chunk,
        "interval_s": interval,
        "buckets": list(buckets),
        "min_drain_hops": min_hops,
        "wire": wire,
        "sustained": bool(sustained),
        "strict": bool(strict),
        "coverage": round(coverage, 6),
        "hops_emitted": hops,
        "expected_hops": lanes * exp_per_lane,
        "detections": detections,
        "events": n_events[0],
        "losses": {
            "ring_overflows": ring_over,
            "ring_dropped": int(ring_drop),
            "bank_overflows": bank_over,
            "bank_dropped": int(bank_drop),
            "drain_errors": proc.drain_errors,
        },
        "feed": {
            "wall_s": round(t_feed, 2),
            "nominal_s": seconds,
            "busy_s": round(feed_busy[0], 2),
            "busy_frac": round(feed_busy[0] / t_feed, 4),
            "tick_late_p50_ms": round(pct(late, 50) * 1e3, 2),
            "tick_late_p99_ms": round(pct(late, 99) * 1e3, 2),
            "tick_late_max_ms": round(float(late.max()) * 1e3, 2),
        },
        "drain": {
            "rounds": len(dev_wall),
            "drains": len(drain_wall),
            "wall_p50_ms": round(pct(drain_wall, 50) * 1e3, 2),
            "wall_p99_ms": round(pct(drain_wall, 99) * 1e3, 2),
            "wall_max_ms": round(max(drain_wall) * 1e3, 2)
            if drain_wall
            else 0.0,
            "device_p50_ms": round(pct(dev_wall, 50) * 1e3, 2),
            "device_p99_ms": round(pct(dev_wall, 99) * 1e3, 2),
            "host_p50_ms": round(pct(drain_host, 50) * 1e3, 2),
            "host_sum_s": round(sum(drain_host), 2),
            "device_sum_s": round(sum(dev_wall), 2),
        },
        "transfer": {
            "wire_MiB": round(wire_bytes[0] / 2**20, 1),
            "wire_MiB_s": round(wire_mib_s, 1),
            "realtime_MiB_s": round(realtime_mib, 1),
            "resend_factor": round(
                wire_mib_s / realtime_mib, 3
            ) if realtime_mib else 0.0,
        },
        "end_backlog_samples": int(backlog),
        "backlog_high_water_samples": int(backlog_hw[0]),
        "backlog_high_water_s": round(backlog_hw[0] / rate, 2),
        "warm_s": round(t_warm, 1),
        "detection_latency_est_s": round(
            interval + pct(drain_wall, 50), 3
        ),
    }
    log(json.dumps(r))
    verdict = (
        "SUSTAINED (strict)" if strict
        else "SUSTAINED" if sustained
        else "NOT sustained"
    )
    log(
        f"[{label or f'{lanes} lanes'}] {verdict}: coverage {coverage*100:.2f}%, "
        f"losses r{ring_over}/b{bank_over}, feed busy "
        f"{feed_busy[0]/t_feed*100:.0f}%, tick-late p99 "
        f"{pct(late,99)*1e3:.0f} ms, drain wall p50/p99 "
        f"{pct(drain_wall,50)*1e3:.0f}/{pct(drain_wall,99)*1e3:.0f} ms "
        f"(device p50 {pct(dev_wall,50)*1e3:.0f} ms), wire "
        f"{wire_mib_s:.0f} MiB/s ({wire_mib_s/realtime_mib:.2f}x realtime), "
        f"{detections} detections / {n_events[0]} events"
    )
    return r


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", default=os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sample_net.txt"))
    ap.add_argument("--lanes", default="256,1024,2048")
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument(
        "--interval", type=float, default=None,
        help="drain batching window (default: bucket period, i.e. "
        "buckets[-1]*hop/rate; 0 = drain per capture chunk)",
    )
    ap.add_argument("--buckets", default="128")
    ap.add_argument(
        "--min-hops", type=int, default=None,
        help="min_drain_hops (default: smallest bucket)",
    )
    ap.add_argument("--wire", default="float32", choices=["float32", "int16", "mulaw8"])
    ap.add_argument("--buffer-seconds", type=float, default=8.0)
    ap.add_argument(
        "--ring-seconds", type=float, default=None,
        help="per-lane capture ring depth (stall insurance; default 4 "
        "drain intervals)",
    )
    ap.add_argument("--events", default=None, help="write events CSV here")
    ap.add_argument(
        "--allow-cpu", action="store_true",
        help="logic smoke on the CPU backend (numbers are meaningless — "
        "GPU runs must NOT use this)",
    )
    ap.add_argument(
        "--out", default=os.path.join(os.path.dirname(__file__),
                                      "live_scale_results.jsonl")
    )
    args = ap.parse_args()

    buckets = tuple(int(b) for b in args.buckets.split(","))
    min_hops = args.min_hops if args.min_hops is not None else buckets[0]

    from syllable_detector_tpu.config.model_format import load_config

    cfg = load_config(args.net)
    if args.interval is None:
        args.interval = buckets[-1] * cfg.hop / cfg.sampling_rate

    results = []
    for lanes in (int(x) for x in args.lanes.split(",")):
        r = run_point(
            args.net, lanes, args.seconds, args.chunk, args.interval,
            buckets, min_hops, args.wire, args.buffer_seconds,
            events_path=args.events, allow_cpu=args.allow_cpu,
            ring_seconds=args.ring_seconds,
        )
        results.append(r)
        with open(args.out, "a") as fh:
            fh.write(json.dumps(r) + "\n")
        if not r["sustained"]:
            log(f"stopping the sweep at {lanes} lanes (not sustained)")
            break
    best = max((r["lanes"] for r in results if r["sustained"]), default=0)
    print(json.dumps({"live_sustained_lanes": best,
                      "points": [(r["lanes"], r["sustained"])
                                 for r in results]}))


if __name__ == "__main__":
    main()
