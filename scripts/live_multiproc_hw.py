"""Multi-PROCESS live scale: lane shards across worker processes, one
device-owner parent.

In the single-process pipeline one feed/staging thread does the host work
of every lane, so one core bounds the lane count. This harness runs the
scale-out architecture from syllable_detector_tpu/runtime/shard_bank.py
end to end on the GPU:

* each WORKER process runs the full live pipeline for its shard —
  wall-clock simulated capture -> Processor fan-out -> native ring ->
  bank staging (the host-bound work) — by reusing live_scale_hw's
  run_point verbatim, with the bank's ``_wire_outputs`` rewired to a
  shared-memory round-trip;
* the PARENT owns the card (one JAX process per card) and serves
  every staged ``[c_w, need]`` drain round through
  runtime.shard_bank.WireDeviceServer — the same one-device-program
  drains as the single-process bank.

On a multi-core host the workers' staging parallelizes and the
sustained lane count scales with cores until the wire or the card binds.
A worker's "device" wall includes queueing at the parent server: the
true per-shard view of a shared card.

Run:  python scripts/live_multiproc_hw.py --workers 2 --lanes 192 \
          --seconds 60 --wire int16
Smoke: python scripts/live_multiproc_hw.py --workers 2 --lanes 8 \
          --seconds 6 --allow-cpu
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _worker_main(
    worker_id,
    cfg_path,
    lanes_w,
    seconds,
    chunk,
    interval,
    buckets,
    min_hops,
    wire,
    buffer_seconds,
    ring_seconds,
    link_spec,
    req_q,
    resp_q,
    barrier,
    rep_q,
):
    """One shard's full live pipeline. Never initializes a device
    backend: run_point(allow_cpu=True) skips the jax.devices() probe and
    every device round goes through the parent's server."""
    try:
        from syllable_detector_tpu.runtime.shard_bank import (
            _WIRE_NP,
            _attach_shm,
        )
        from live_scale_hw import run_point

        req_name, resp_name, req_shape, resp_shape = link_spec
        req_shm = _attach_shm(req_name)
        resp_shm = _attach_shm(resp_name)
        req_view = np.ndarray(req_shape, _WIRE_NP[wire], buffer=req_shm.buf)
        resp_view = np.ndarray(resp_shape, np.float32, buffer=resp_shm.buf)

        def remote_wire(xs_np):
            need = xs_np.shape[1]
            req_view[:, :need] = xs_np
            req_q.put((worker_id, need))
            r = resp_q.get()
            if isinstance(r, tuple):
                raise RuntimeError(f"device server error: {r[1]}")
            return resp_view[:, :r, :].copy()

        def bank_patch(bank):
            bank._wire_outputs = remote_wire

        r = run_point(
            cfg_path,
            lanes=lanes_w,
            seconds=seconds,
            chunk=chunk,
            interval=interval,
            buckets=buckets,
            min_hops=min_hops,
            wire=wire,
            buffer_seconds=buffer_seconds,
            ring_seconds=ring_seconds,
            allow_cpu=True,  # the device probe/ownership lives in the parent
            bank_patch=bank_patch,
            start_gate=barrier.wait,
            label=f"worker {worker_id}: {lanes_w} lanes",
        )
        rep_q.put(("ok", worker_id, r))
    except Exception:
        import traceback

        rep_q.put(("err", worker_id, traceback.format_exc(limit=12)))
    finally:
        try:
            req_shm.close()
            resp_shm.close()
        except Exception:
            pass


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", default=os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sample_net.txt"))
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--lanes", type=int, default=192, help="TOTAL lanes")
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--interval", type=float, default=None)
    ap.add_argument("--buckets", default="128")
    ap.add_argument("--min-hops", type=int, default=None)
    ap.add_argument(
        "--wire", default="int16", choices=["float32", "int16", "mulaw8"]
    )
    ap.add_argument("--buffer-seconds", type=float, default=120.0)
    ap.add_argument("--ring-seconds", type=float, default=90.0)
    ap.add_argument("--allow-cpu", action="store_true")
    ap.add_argument(
        "--out",
        default=os.path.join(
            os.path.dirname(__file__), "live_multiproc_results.jsonl"
        ),
    )
    args = ap.parse_args()

    import jax

    from syllable_detector_tpu.config.model_format import load_config
    from syllable_detector_tpu.runtime.shard_bank import WireDeviceServer

    if not args.allow_cpu:
        dev = jax.devices()[0]
        assert dev.platform != "cpu", f"needs a GPU, got {dev}"

    buckets = tuple(int(b) for b in args.buckets.split(","))
    min_hops = args.min_hops if args.min_hops is not None else buckets[0]
    cfg = load_config(args.net)
    rate = float(cfg.sampling_rate)
    interval = (
        args.interval if args.interval is not None
        else buckets[-1] * cfg.hop / rate
    )

    base, extra = divmod(args.lanes, args.workers)
    sizes = [base + (1 if w < extra else 0) for w in range(args.workers)]
    assert all(sizes), "more workers than lanes"
    shard_cfgs = [[cfg] * c for c in sizes]

    t0 = time.monotonic()
    server = WireDeviceServer(
        shard_cfgs,
        buckets=buckets,
        transfer_dtype=args.wire,
        min_drain_hops=min_hops,
    )
    n_shapes = server.warm_up()  # compile BEFORE any wall clock starts
    t_warm = time.monotonic() - t0
    log(
        f"[parent] warmed {n_shapes} drain shape(s) across "
        f"{args.workers} shards in {t_warm:.1f}s "
        f"(wire={args.wire}, buckets={buckets}, shards={sizes})"
    )
    server.start()

    ctx = server.ctx
    barrier = ctx.Barrier(args.workers)
    rep_q = ctx.Queue()
    procs = []
    for w in range(args.workers):
        p = ctx.Process(
            target=_worker_main,
            args=(
                w,
                args.net,
                sizes[w],
                args.seconds,
                args.chunk,
                interval,
                buckets,
                min_hops,
                args.wire,
                args.buffer_seconds,
                args.ring_seconds,
                server.link_specs[w],
                server.req_q,
                server.resp_qs[w],
                barrier,
                rep_q,
            ),
            daemon=True,
        )
        p.start()
        procs.append(p)

    reports = {}
    deadline = time.monotonic() + args.seconds * 4 + 900
    while len(reports) < args.workers:
        timeout = max(1.0, deadline - time.monotonic())
        r = rep_q.get(timeout=timeout)
        if r[0] == "err":
            log(f"[worker {r[1]}] FAILED:\n{r[2]}")
            reports[r[1]] = None
        else:
            reports[r[1]] = r[2]
    for p in procs:
        p.join(timeout=30)
    server.stop()

    ok = [r for r in reports.values() if r is not None]
    sustained = len(ok) == args.workers and all(r["sustained"] for r in ok)
    agg = {
        "harness": "multiproc",
        "workers": args.workers,
        "shard_lanes": sizes,
        "lanes": args.lanes,
        "seconds": args.seconds,
        "wire": args.wire,
        "buckets": list(buckets),
        "min_drain_hops": min_hops,
        "interval_s": interval,
        "sustained": bool(sustained),
        "strict": bool(sustained and all(r["strict"] for r in ok)),
        "warm_s": round(t_warm, 1),
        "per_worker": [
            (
                None
                if r is None
                else {
                    "lanes": r["lanes"],
                    "sustained": r["sustained"],
                    "coverage": r["coverage"],
                    "feed_busy_frac": r["feed"]["busy_frac"],
                    "feed_wall_s": r["feed"]["wall_s"],
                    "tick_late_p99_ms": r["feed"]["tick_late_p99_ms"],
                    "drain_wall_p50_ms": r["drain"]["wall_p50_ms"],
                    "drain_wall_p99_ms": r["drain"]["wall_p99_ms"],
                    "device_p50_ms": r["drain"]["device_p50_ms"],
                    "wire_MiB_s": r["transfer"]["wire_MiB_s"],
                    "losses": r["losses"],
                    "detections": r["detections"],
                    "backlog_high_water_s": r["backlog_high_water_s"],
                }
            )
            for _, r in sorted(reports.items())
        ],
    }
    print(json.dumps(agg))
    with open(args.out, "a") as fh:
        fh.write(json.dumps(agg) + "\n")
    log(
        f"[total {args.lanes} lanes / {args.workers} procs] "
        + ("SUSTAINED" if sustained else "NOT sustained")
    )
    return 0 if sustained else 1


if __name__ == "__main__":
    sys.exit(main())
