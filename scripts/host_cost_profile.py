"""Isolate the live pipeline's HOST costs (single-core budget).

One host core does the live pipeline's fan-out and staging; this harness
measures each host-side stage in isolation (device stubbed out) so the
next native optimization targets the real top cost:

  * bank drain staging: consolidate + quantize + [n_lanes, need] assembly
  * worker ring->bank feed: peek/consume/append/gap-splice loop
  * capture fan-out: receive_audio_block (bulk native ring produce)

Run: python scripts/host_cost_profile.py --lanes 384 --rounds 20
"""

import argparse
import cProfile
import io
import os
import pstats
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=384)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--wire", default="mulaw8")
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument(
        "--no-native",
        action="store_true",
        help="disable the native drain stager (A/B the numpy staging loop)",
    )
    args = ap.parse_args()

    from syllable_detector_tpu.config.model_format import load_config
    from syllable_detector_tpu.models.detector_bank import DetectorBank

    cfg = load_config(os.environ.get("SD_NET", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "sample_net.txt")))
    lanes = args.lanes
    rate = cfg.sampling_rate

    bank = DetectorBank(
        [cfg] * lanes,
        max_buffer_seconds=60.0,
        buckets=(128,),
        transfer_dtype=args.wire,
        min_drain_hops=128,
    )
    # stub the device: staging cost only (the staged array IS consumed,
    # so the quantize work cannot be elided)
    sink = [0.0]
    out_shape = None

    def fake_wire(xs_np):
        sink[0] += float(xs_np[0, 0]) + float(xs_np[-1, -1])
        return np.zeros(out_shape, np.float32)

    bank._wire_outputs = fake_wire
    if args.no_native:
        bank._stager = None

    spec = bank.spec
    hop = spec.hop
    round_samples = 128 * hop + 4096  # a bit over one bucket per round
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.standard_normal(round_samples * 2)).astype(np.float32)
    out_shape = (lanes, 128, spec.net.outputs)

    # --- 1) bank staging: append (big chunks) + drain ---------------------
    t_append = 0.0
    t_drain = 0.0
    for r in range(args.rounds):
        o = (r * 977) % round_samples
        chunk = audio[o : o + round_samples]
        t0 = time.perf_counter()
        for i in range(lanes):
            bank.append_audio_data(i, chunk)
        t_append += time.perf_counter() - t0
        t0 = time.perf_counter()
        if args.profile and r == args.rounds - 1:
            pr = cProfile.Profile()
            pr.enable()
            bank.drain()
            pr.disable()
            s = io.StringIO()
            pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(25)
            print(s.getvalue(), file=sys.stderr)
        else:
            bank.drain()
        t_drain += time.perf_counter() - t0
    per_round_ms = 1000 * t_drain / args.rounds
    audio_ms = 1000 * round_samples / rate
    print(
        f"bank drain (staging only): {per_round_ms:.1f} ms/round for "
        f"{audio_ms:.0f} ms of audio x {lanes} lanes "
        f"=> {100 * per_round_ms / audio_ms:.1f}% of one core"
    )
    print(
        f"bank append (one {round_samples}-sample chunk/lane): "
        f"{1000 * t_append / args.rounds:.1f} ms/round "
        f"({100 * (t_append / args.rounds) / (audio_ms / 1000):.1f}% of core)"
    )

    # --- 2) small-chunk append (capture-sized) ----------------------------
    bank2 = DetectorBank(
        [cfg] * lanes,
        max_buffer_seconds=60.0,
        buckets=(128,),
        transfer_dtype=args.wire,
        min_drain_hops=128,
    )
    bank2._wire_outputs = fake_wire
    if args.no_native:
        bank2._stager = None
    n_chunks = round_samples // args.chunk
    t0 = time.perf_counter()
    for r in range(args.rounds):
        for c in range(n_chunks):
            o = (c * args.chunk) % round_samples
            piece = audio[o : o + args.chunk]
            for i in range(lanes):
                bank2.append_audio_data(i, piece)
        bank2.drain()
    t_small = time.perf_counter() - t0
    print(
        f"small-chunk append+drain: {1000 * t_small / args.rounds:.1f} ms/round "
        f"({100 * (t_small / args.rounds) / (n_chunks * args.chunk / rate):.1f}% of core)"
    )

    # --- 3) capture fan-out + worker feed via Processor --------------------
    from syllable_detector_tpu.runtime.audio_io import SimulatedAudioInput
    from syllable_detector_tpu.runtime.processor import (
        CallbackOutput,
        Processor,
        ProcessorEntry,
    )

    def source(ch, start, n):
        o = start % round_samples
        return audio[o : o + n]

    total = args.rounds * n_chunks * args.chunk
    iface = SimulatedAudioInput(
        source,
        channels=lanes,
        sample_rate=rate,
        frame_size=args.chunk,
        realtime=False,
        total_samples=total,
    )
    proc = Processor(
        iface,
        [
            ProcessorEntry(input_channel=i, output_channel=i, config=cfg)
            for i in range(lanes)
        ],
        CallbackOutput(lambda i, e, s: None),
        ring_seconds=round_samples * 2 / rate,
        batched=True,
        bank_buffer_seconds=60.0,
        bank_buckets=(128,),
        bank_transfer_dtype=args.wire,
        bank_min_drain_hops=128,
        drain_interval=128 * hop / rate,
    )
    proc._bank._wire_outputs = fake_wire
    if args.no_native:
        proc._bank._stager = None
    fan_busy = [0.0]
    orig = proc.receive_audio_block

    def timed_block(i, b):
        t0 = time.perf_counter()
        orig(i, b)
        fan_busy[0] += time.perf_counter() - t0

    iface.block_delegate = timed_block
    t0 = time.perf_counter()
    proc.set_up()
    iface.wait_until_done(timeout=600)
    proc.drain_pending(timeout=60)
    t_all = time.perf_counter() - t0
    proc.tear_down()
    audio_s = total / rate
    print(
        f"processor end-to-end (device stubbed): {t_all:.1f} s for "
        f"{audio_s:.1f} s x {lanes} lanes => {100 * t_all / audio_s:.0f}% of core"
    )
    print(
        f"  capture fan-out: {fan_busy[0]:.2f} s ({100 * fan_busy[0] / audio_s:.1f}% of core)"
    )


if __name__ == "__main__":
    main()
