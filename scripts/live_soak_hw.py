"""Long-duration live soak on the GPU.

Runs the ACTUAL live pipeline (wall-clock simulated capture ->
Processor.receive_audio fan-out -> ring -> worker -> batched DetectorBank
drains -> live event log) for 10+ minutes at a
sustained lane count, with capture-device gaps INJECTED mid-run, and
checks the properties a closed-loop experiment depends on over hours:

  * exact hop accounting across injected gaps (per-lane segment algebra:
    every audio segment between gaps contributes
    max(0, num_frames(len) - time_range + 1) hops — the same contract
    the CPU pressure soak pins, here under real device timing);
  * bounded memory: RSS sampled every 10 s must stop growing after the
    warm period (no leak in rings / bank segment buffers / event log
    bookkeeping);
  * bounded backlog: bank buffered samples never exceed the drain window;
  * event-log growth: events flow for the whole run and carry
    sample-accurate stream indices (spot-checked monotone per channel);
  * drain-latency histogram (printed, recorded).

Extends tests/test_runtime.py's 20 s CPU pressure soak to real hardware
timing (the regime the reference's RT thread runs in,
reference: SyllableDetector/Processor.swift:102-149).

Run: python scripts/live_soak_hw.py --lanes 128 --seconds 600 --wire int16
Results append to scripts/live_soak_results.jsonl.
"""

import argparse
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from live_scale_hw import make_chirp, pct  # shared generator + percentile


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def rss_mib():
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", default=os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sample_net.txt"))
    ap.add_argument("--lanes", type=int, default=128)
    ap.add_argument("--seconds", type=float, default=600.0)
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--wire", default="int16", choices=["float32", "int16", "mulaw8"])
    ap.add_argument("--buckets", default="128")
    ap.add_argument(
        "--gap-every", type=float, default=60.0,
        help="inject a capture-device gap every N seconds (0 = none)",
    )
    ap.add_argument(
        "--gap-frames", type=int, default=4410,
        help="lost frames per injected gap (0.1 s at 44.1 kHz)",
    )
    ap.add_argument(
        "--ring-seconds", type=float, default=90.0,
        help="capture ring depth (stall insurance)",
    )
    ap.add_argument("--buffer-seconds", type=float, default=120.0)
    ap.add_argument("--allow-cpu", action="store_true",
                    help="logic smoke on CPU (numbers meaningless)")
    ap.add_argument(
        "--out", default=os.path.join(os.path.dirname(__file__),
                                      "live_soak_results.jsonl")
    )
    args = ap.parse_args()

    import jax

    from syllable_detector_tpu.config.model_format import load_config
    from syllable_detector_tpu.models.detector import (
        detector_spec_from_config,
    )
    from syllable_detector_tpu.ops.stft import num_frames
    from syllable_detector_tpu.runtime.audio_io import SimulatedAudioInput
    from syllable_detector_tpu.runtime.processor import (
        CallbackOutput,
        Processor,
        ProcessorEntry,
    )

    dev = jax.devices()[0]
    if not args.allow_cpu:
        assert dev.platform != "cpu", f"needs a GPU, got {dev}"
    cfg = load_config(args.net)
    spec, _ = detector_spec_from_config(cfg)
    rate = float(cfg.sampling_rate)
    lanes = args.lanes
    buckets = tuple(int(b) for b in args.buckets.split(","))
    interval = buckets[-1] * cfg.hop / rate
    rng = np.random.default_rng(13)

    loop_n = int(np.ceil(4.0 * rate / args.chunk)) * args.chunk
    noise = (0.02 * rng.standard_normal(loop_n)).astype(np.float32)
    chirp = make_chirp(rate, loop_n / rate, rng)[:loop_n]

    def source(ch, start, n):
        buf = chirp if ch == 0 else noise
        o = start % loop_n
        return buf[o : o + n]

    total = int(args.seconds * rate)
    interface = SimulatedAudioInput(
        source, channels=lanes, sample_rate=rate,
        frame_size=args.chunk, realtime=True, total_samples=total,
    )
    entries = [
        ProcessorEntry(input_channel=i, output_channel=i, config=cfg)
        for i in range(lanes)
    ]

    events = []  # (channel, sample) — stream indices per event

    def event_sink(channel, sample, secs, outputs):
        events.append((channel, sample))

    proc = Processor(
        interface, entries, CallbackOutput(lambda i, e, s: None),
        ring_seconds=args.ring_seconds, batched=True,
        event_log=event_sink, bank_buffer_seconds=args.buffer_seconds,
        bank_buckets=buckets, bank_transfer_dtype=args.wire,
        bank_min_drain_hops=buckets[0], drain_interval=interval,
    )
    bank = proc._bank
    assert bank is not None

    # --- instrumentation: drain latency + gap injection on the capture
    # thread (receive_* bookkeeping is single-writer by contract)
    drain_wall = []
    orig_drain = bank.drain

    def timed_drain(flush=False):
        t = time.monotonic()
        out = orig_drain(flush=flush)
        drain_wall.append(time.monotonic() - t)
        return out

    bank.drain = timed_drain

    # per-lane closed-segment lengths (produced-sample positions at each
    # injected gap) -> exact expected hop counts
    seg_start = [0] * lanes
    segments = [[] for _ in range(lanes)]
    gap_state = {"next": args.gap_every or np.inf, "count": 0}
    t_state = {"t0": None}
    orig_recv = proc.receive_audio

    def _maybe_inject(iface):
        # inject BEFORE the chunk, on the capture thread, at whole-run
        # wall-clock marks
        if t_state["t0"] is None:
            return
        elapsed = time.monotonic() - t_state["t0"]
        if elapsed >= gap_state["next"]:
            gap_state["next"] += args.gap_every
            gap_state["count"] += 1
            for i, lane in enumerate(proc._lanes):
                segments[i].append(lane.produced_samples - seg_start[i])
                seg_start[i] = lane.produced_samples
            proc.receive_capture_gap(iface, args.gap_frames)
            log(f"[gap {gap_state['count']}] injected "
                f"{args.gap_frames} lost frames at t={elapsed:.1f}s")

    def injecting_recv(iface, ch, data):
        if ch == 0:
            _maybe_inject(iface)
        orig_recv(iface, ch, data)

    orig_recv_block = proc.receive_audio_block

    def injecting_recv_block(iface, block):
        _maybe_inject(iface)
        orig_recv_block(iface, block)

    interface.delegate = injecting_recv
    interface.block_delegate = injecting_recv_block

    t0 = time.monotonic()
    n_shapes = proc.warm_up()
    log(f"[{lanes} lanes] warmed {n_shapes} drain shape(s) in "
        f"{time.monotonic() - t0:.1f}s (wire={args.wire}, "
        f"buckets={buckets}, interval={interval:.3f}s); "
        f"soaking {args.seconds:.0f}s with a gap every {args.gap_every}s")

    rss0 = rss_mib()
    rss_samples = []  # (t, rss_mib, max_backlog, n_events)
    data_samples = []  # (t, ring_data_mib, bank_data_mib)
    stop_sampler = threading.Event()

    def sampler():
        while not stop_sampler.wait(10.0):
            backlog = max(bank.buffered_samples(i) for i in range(lanes))
            rss_samples.append(
                (time.monotonic() - t_state["t0"], rss_mib(), backlog,
                 len(events))
            )
            # data-level truth next to the RSS high-water: what the
            # pipeline actually HOLDS right now (MiB)
            ring_mib = sum(l.ring.fill for l in proc._lanes) * 4 / 2**20
            bank_mib = sum(
                bank.buffered_samples(i) for i in range(lanes)
            ) * 4 / 2**20
            data_samples.append((rss_samples[-1][0], ring_mib, bank_mib))

    t_state["t0"] = time.monotonic()
    sampler_t = threading.Thread(target=sampler, daemon=True)
    sampler_t.start()
    proc.set_up()
    done = interface.wait_until_done(timeout=args.seconds * 2 + 300)
    t_feed = time.monotonic() - t_state["t0"]
    proc.drain_pending(timeout=120)
    bank.drain(flush=True)
    stop_sampler.set()
    sampler_t.join(timeout=5)
    proc.tear_down()

    # --- exact hop accounting across the injected gaps -------------------
    for i, lane in enumerate(proc._lanes):
        segments[i].append(lane.produced_samples - seg_start[i])
    w, o, tr = spec.window_length, spec.window_overlap, spec.time_range

    def seg_hops(n):
        return max(0, num_frames(int(n), w, o) - tr + 1)

    expected = sum(sum(seg_hops(s) for s in segments[i]) for i in range(lanes))
    hops = int(np.sum(bank.hops_emitted))
    stats = proc.lane_stats()
    ring_over = sum(s["overflows"] for s in stats)
    cap_gaps = sum(s["capture_gaps"] for s in stats)
    # every injected capture gap is SPLICED into the bank as a counted
    # gap (note_gap increments overflows/dropped_samples by design —
    # that's the sample-accurate stream-clock accounting); exactness
    # means NO drops beyond the injected ones and exact hop algebra
    injected = lanes * gap_state["count"]
    injected_samples = injected * args.gap_frames
    bank_gaps = sum(bank.overflows)
    bank_dropped = sum(bank.dropped_samples)
    exact = (
        hops == expected
        and ring_over == 0
        and bank_gaps == injected
        and bank_dropped == injected_samples
    )

    # --- event-log stream indices monotone per channel -------------------
    last = {}
    monotone = True
    for ch, sample in events:
        if ch in last and sample <= last[ch]:
            monotone = False
        last[ch] = sample

    # --- memory boundedness ------------------------------------------------
    # RSS is NOT a leak detector here: it counts (a) ring pages touched
    # once through BOTH mirror mappings (lanes x ring_seconds x 4 B x 2,
    # one-time, saturating after ~2 ring wraps), and (b) the glibc arena
    # HIGH-WATER from stall-backlog spikes (8 KiB chunk copies + segment
    # consolidation transients are freed to the allocator but the pages
    # stay with the process). The no-leak property itself is pinned by a
    # The assertion is the CONFIGURED bound: RSS must stay under the static budget every
    # buffer in the pipeline can reach at once.
    budget_mib = (
        rss_samples[0][1] if rss_samples else rss0
    ) + lanes * rate * 4 * (
        args.ring_seconds * 2  # ring pages, both mirror mappings
        # bank cap x2.5: the cap's audio lives as an arena HIGH-WATER of
        # mixed 8 KiB chunk copies + peeked catch-up slabs + one
        # consolidation transient
        + args.buffer_seconds * 2.5
    ) / 2**20 + 1024.0  # fixed slack: staging, jit arenas
    peak_rss = max((r for _, r, _, _ in rss_samples), default=rss0)
    # diagnostic only (reported, not pass/fail): slope over post-warm
    # low-backlog samples — the arena ratchet can make this positive on
    # a stall-heavy link even with zero leak
    warm_skip = min(60.0, args.seconds / 3.0)
    healthy = [
        (t, r) for t, r, b, _ in rss_samples
        if t > warm_skip and b < 5.0 * rate
    ]
    if len(healthy) >= 5:
        ts = np.array([t for t, _ in healthy])
        rs = np.array([r for _, r in healthy])
        slope_mib_min = float(np.polyfit(ts, rs, 1)[0] * 60.0)
    else:
        slope_mib_min = 0.0
    max_backlog = max((b for _, _, b, _ in rss_samples), default=0)
    # link health: insured rings should never overflow and drains should
    # not tail out — ring overflows mean the link stalled past the
    # insurance, which is an ENVIRONMENT failure, not a framework one
    link_degraded = ring_over > 0 or (
        len(drain_wall) > 10
        and pct(np.asarray(drain_wall) * 1e3, 99) > 3000.0
    )

    hist_edges = [0, 50, 100, 200, 400, 800, 1600, 3200, 1e9]
    ms = np.asarray(drain_wall) * 1e3
    hist = np.histogram(ms, hist_edges)[0]

    reasons = []
    if not done:
        reasons.append("feed did not complete")
    if not exact:
        reasons.append(
            "hop/drop algebra inexact"
            + (" (ring overflows from link stalls)" if ring_over else "")
        )
    if not monotone:
        reasons.append("event indices non-monotone")
    if cap_gaps != injected:
        reasons.append("capture-gap records != injections")
    if t_feed > args.seconds * 1.02:
        reasons.append("feed below realtime")
    if peak_rss > budget_mib:
        reasons.append(
            f"RSS {peak_rss:.0f} MiB exceeded the configured budget "
            f"{budget_mib:.0f} MiB (leak, or buffers past their caps)"
        )
    ok = not reasons
    r = {
        "ok": bool(ok),
        "reasons": reasons,
        "link_degraded": bool(link_degraded),
        "lanes": lanes,
        "seconds": args.seconds,
        "wire": args.wire,
        "gaps_injected": gap_state["count"],
        "capture_gaps_recorded": cap_gaps,
        "hops_emitted": hops,
        "hops_expected": expected,
        "exact_accounting": bool(exact),
        "events": len(events),
        "events_monotone": bool(monotone),
        "detections": sum(proc.lane_detections()),
        "losses": {
            "ring_overflows": ring_over,
            "bank_gap_splices": bank_gaps,
            "bank_dropped_samples": bank_dropped,
            "injected_gap_samples": injected_samples,
        },
        "rss_mib_start": round(rss0, 1),
        "rss_mib_end": round(rss_samples[-1][1] if rss_samples else rss0, 1),
        "rss_mib_peak": round(peak_rss, 1),
        "rss_budget_mib": round(budget_mib, 1),
        "rss_slope_mib_per_min_healthy": round(slope_mib_min, 3),
        "max_backlog_samples": int(max_backlog),
        "timeline_10s": [
            [round(t, 1), round(rss, 1), int(b), e]
            for t, rss, b, e in rss_samples
        ],
        "data_timeline_10s": [
            [round(t, 1), round(rg, 1), round(bk, 1)]
            for t, rg, bk in data_samples
        ],
        "data_peak_mib": round(
            max((rg + bk for _, rg, bk in data_samples), default=0.0), 1
        ),
        "drain_ms": {
            "n": len(ms),
            "p50": round(pct(ms, 50), 1),
            "p90": round(pct(ms, 90), 1),
            "p99": round(pct(ms, 99), 1),
            "max": round(float(ms.max()), 1) if len(ms) else 0.0,
            "hist_edges_ms": hist_edges[:-1],
            "hist": [int(h) for h in hist],
        },
        "feed_wall_s": round(t_feed, 1),
    }
    log(json.dumps(r))
    with open(args.out, "a") as fh:
        fh.write(json.dumps(r) + "\n")
    log(f"{'SOAK OK' if ok else 'SOAK FAILED'}: {hops}/{expected} hops "
        f"across {gap_state['count']} injected gaps, {len(events)} events "
        f"(monotone={monotone}), RSS {rss0:.0f}->"
        f"{r['rss_mib_end']:.0f} MiB (peak {peak_rss:.0f} vs budget "
        f"{budget_mib:.0f}; {slope_mib_min:+.2f} MiB/min healthy-slope "
        f"diagnostic), "
        f"drain p50/p99 {r['drain_ms']['p50']}/{r['drain_ms']['p99']} ms"
        + (f"; link degraded" if link_degraded else "")
        + (f"; reasons: {reasons}" if reasons else ""))
    print(json.dumps({"soak_ok": ok, "lanes": lanes,
                      "seconds": args.seconds}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
