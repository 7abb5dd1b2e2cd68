"""Lane-sharded multi-process DetectorBank: scale the live host pipeline
past one CPU core.

In the single-process pipeline one thread does capture fan-out and drain
staging for every lane, so the host core, not the device, bounds the lane
count. The reference has the same shape in miniature: ONE realtime thread
doing all host work per Processor (reference:
SyllableDetector/Processor.swift:102-149). This module is the scale-out:

* **Workers** (one process per lane shard) own everything host-bound —
  segment accounting, gap splicing, drain staging (the native
  ``sdstage`` quantize+assemble call), exactly the per-lane algebra of
  :class:`~syllable_detector_tpu.models.detector_bank.DetectorBank`,
  which they subclass. They never start a JAX backend (nets stay host
  numpy; the staged rounds go to the parent).
* **The parent** owns the card (a JAX process reserves most of a GPU's
  memory, so one process per card) and runs a device-server thread:
  each staged ``[c_w, need]`` wire buffer arrives via shared memory, is
  evaluated with the same one-device-program drain the single-process
  bank uses (the server delegates to a real eval-only ``DetectorBank``
  per shard), and the ``[c_w, n_evals, outputs]`` block returns through
  the shard's response window.

Workers therefore burn their own cores on staging while device rounds
serialize at the parent — the correct split for a one-card host.

Transport is ``multiprocessing.shared_memory`` + queues: one request
arena and one response arena per worker (sized for the largest drain
bucket), a shared request queue into the server, and a per-worker
response queue. A whole drain round moves host->host with ONE memcpy
each way; pickling is reserved for the small per-drain metadata reply.

Processes use the ``spawn`` start method: forking a parent whose device
client is initialized duplicates runtime state the child cannot use.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import traceback
from multiprocessing import get_context
from multiprocessing import shared_memory as shm_mod

import numpy as np

from syllable_detector_tpu.models.detector_bank import DetectorBank
from syllable_detector_tpu.models.detector import detector_spec_from_config
from syllable_detector_tpu.ops.stft import normalize_overlap, num_frames
from syllable_detector_tpu.ops.wire import WIRE_DTYPES

__all__ = ["ShardedDetectorBank", "WireDeviceServer"]

# live deployments pin a single drain bucket (one compiled shape); the
# default here is the live deployment profile rather than the full ladder
_DEFAULT_BUCKETS = (128,)


def _drain_geometry(spec, buckets):
    """(need, n_evals) for each drain bucket — identical arithmetic to
    DetectorBank.drain so both sides of the wire agree on shapes."""
    t = spec.time_range
    hop = spec.hop
    gap, _ = normalize_overlap(spec.window_overlap)
    out = {}
    for b in buckets:
        need = (b + t - 2) * hop + gap + spec.window_length
        f = num_frames(need, spec.window_length, spec.window_overlap)
        out[need] = f - t + 1
    return out


def _attach_shm(name: str) -> shm_mod.SharedMemory:
    """Attach to an existing segment WITHOUT letting this process's
    resource tracker adopt it: on 3.12 an attach registers the name, and
    the tracker unlinks it when the worker exits — yanking the arena out
    from under the parent and the other workers (cpython bpo-39959).
    Suppressing register() during the attach (rather than unregistering
    after) also keeps the tracker daemon from logging KeyErrors for
    names it never owned."""
    from multiprocessing import resource_tracker

    orig = resource_tracker.register
    resource_tracker.register = lambda *a, **k: None
    try:
        return shm_mod.SharedMemory(name=name)
    finally:
        resource_tracker.register = orig


class _DeviceLink:
    """Worker-side handle to the parent device server."""

    def __init__(self, worker_id, req_view, resp_view, req_q, resp_q):
        self.worker_id = worker_id
        self.req_view = req_view
        self.resp_view = resp_view
        self.req_q = req_q
        self.resp_q = resp_q


class _RemoteWireBank(DetectorBank):
    """A DetectorBank whose device evaluation happens in ANOTHER process.

    Everything host-side (segments, gap algebra, native drain staging,
    bucketing, output bookkeeping) is inherited unchanged; only
    ``_wire_outputs`` is replaced by a shared-memory round-trip to the
    parent's device server. The staged wire buffer is already in the
    final transfer dtype, so the copy into the request arena is the only
    extra host cost vs the single-process bank."""

    def __init__(self, configs, link: _DeviceLink, **kwargs):
        super().__init__(configs, **kwargs)
        self._link = link

    def _wire_outputs(self, xs_np):
        link = self._link
        need = xs_np.shape[1]
        link.req_view[:, :need] = xs_np
        link.req_q.put((link.worker_id, need))
        r = link.resp_q.get()
        if isinstance(r, tuple):  # ("err", text)
            raise RuntimeError(f"device server failed a drain round: {r[1]}")
        # copy OUT of the response window: drain() keeps row views of this
        # array across bucket rounds, and the next round overwrites the
        # arena in place
        return link.resp_view[:, :r, :].copy()


def _worker_main(
    worker_id,
    configs,
    bank_kwargs,
    req_name,
    resp_name,
    req_shape,
    resp_shape,
    wire,
    cmd_q,
    rep_q,
    req_q,
    devresp_q,
):
    """Worker process entry: run the shard's bank against the command
    stream. Never initializes a device backend — the only jax this
    process does is module imports."""
    req_shm = _attach_shm(req_name)
    resp_shm = _attach_shm(resp_name)
    try:
        req_view = np.ndarray(req_shape, WIRE_DTYPES[wire], buffer=req_shm.buf)
        resp_view = np.ndarray(resp_shape, np.float32, buffer=resp_shm.buf)
        link = _DeviceLink(worker_id, req_view, resp_view, req_q, devresp_q)
        bank = _RemoteWireBank(configs, link, **bank_kwargs)
        pending_err = None
        while True:
            msg = cmd_q.get()
            op = msg[0]
            if op == "stop":
                break
            try:
                if op == "backends":
                    from jax._src import xla_bridge

                    rep_q.put(("ok", xla_bridge.backends_are_initialized()))
                elif op == "append":
                    bank.append_audio_data(msg[1], msg[2])
                elif op == "gap":
                    bank.note_gap(msg[1], msg[2])
                elif op == "drain":
                    if pending_err is not None:
                        rep_q.put(("err", pending_err))
                        pending_err = None
                        continue
                    res = bank.drain(flush=msg[1])
                    c = bank.n_lanes
                    valid = (
                        np.concatenate(
                            [res[i, : bank.last_counts[i]] for i in range(c)]
                        )
                        if res.shape[1]
                        else np.zeros((0, res.shape[2]), np.float32)
                    )
                    rep_q.put(
                        (
                            "ok",
                            bank.last_counts.copy(),
                            [a.copy() for a in bank.last_sample_indices],
                            valid,
                            list(bank.overflows),
                            list(bank.dropped_samples),
                            list(bank.hops_emitted),
                        )
                    )
            except Exception:
                err = traceback.format_exc(limit=8)
                if op == "drain":
                    rep_q.put(("err", err))
                else:
                    # appends/gaps are fire-and-forget; surface the
                    # failure at the next synchronous point
                    pending_err = err
    finally:
        req_shm.close()
        resp_shm.close()


class WireDeviceServer:
    """The parent-process device half of the sharded bank: owns the
    card, one shared-memory request/response arena pair per worker, and
    a server thread that evaluates staged ``[c_w, need]`` wire rounds
    through a real eval-only :class:`DetectorBank` per shard (so the
    one-device-program drains and wire dequant are byte-for-byte the
    single-process code).

    Reused by :class:`ShardedDetectorBank` (generic command-driven
    workers) and by ``scripts/live_multiproc_hw.py`` (workers that run a
    full wall-clock Processor pipeline per shard)."""

    def __init__(
        self,
        shard_configs,
        buckets: tuple = _DEFAULT_BUCKETS,
        transfer_dtype: str = "float32",
        min_drain_hops: int = 1,
        ctx=None,
    ):
        if transfer_dtype not in WIRE_DTYPES:
            raise ValueError(f"unknown transfer_dtype {transfer_dtype!r}")
        self.ctx = ctx if ctx is not None else get_context("spawn")
        self.wire = transfer_dtype
        self.n_workers = len(shard_configs)
        self.spec = detector_spec_from_config(shard_configs[0][0])[0]
        out_w = self.spec.net.outputs
        geom = _drain_geometry(self.spec, buckets)
        need_max = max(geom)
        ne_max = max(geom.values())
        itemsize = np.dtype(WIRE_DTYPES[transfer_dtype]).itemsize
        self.req_q = self.ctx.Queue()
        self.resp_qs = [self.ctx.Queue() for _ in range(self.n_workers)]
        self._shms: list[shm_mod.SharedMemory] = []
        self.req_views = []
        self.resp_views = []
        self.link_specs = []  # per worker: what its process needs to attach
        self.banks = []
        try:
            for w, cfgs_w in enumerate(shard_configs):
                c = len(cfgs_w)
                req = shm_mod.SharedMemory(
                    create=True, size=max(1, c * need_max * itemsize)
                )
                resp = shm_mod.SharedMemory(
                    create=True, size=max(1, c * ne_max * out_w * 4)
                )
                self._shms += [req, resp]
                req_shape = (c, need_max)
                resp_shape = (c, ne_max, out_w)
                self.req_views.append(
                    np.ndarray(req_shape, WIRE_DTYPES[transfer_dtype], buffer=req.buf)
                )
                self.resp_views.append(
                    np.ndarray(resp_shape, np.float32, buffer=resp.buf)
                )
                self.link_specs.append(
                    (req.name, resp.name, req_shape, resp_shape)
                )
                self.banks.append(
                    DetectorBank(
                        list(cfgs_w),
                        buckets=buckets,
                        transfer_dtype=transfer_dtype,
                        min_drain_hops=min_drain_hops,
                    )
                )
        except Exception:
            self.stop()
            raise
        self._thread = None

    def start(self):
        self._thread = threading.Thread(
            target=self._serve, name="shard-bank-device-server", daemon=True
        )
        self._thread.start()
        return self

    def _serve(self):
        while True:
            msg = self.req_q.get()
            if msg is None:
                return
            w, need = msg
            try:
                xs = self.req_views[w][:, :need]
                out = np.asarray(self.banks[w]._wire_outputs(xs))
                ne = out.shape[1]
                self.resp_views[w][:, :ne, :] = out
                self.resp_qs[w].put(ne)
            except Exception:
                self.resp_qs[w].put(("err", traceback.format_exc(limit=8)))

    def warm_up(self) -> int:
        """Compile every drain-bucket device program eagerly (call before
        .start() or from the server thread's owner — not concurrently
        with live serving). Identical shard shapes dedupe through the
        persistent XLA compile cache: the params are traced arguments,
        so W same-sized shards share one HLO."""
        n = 0
        for w, bank in enumerate(self.banks):
            for need in _drain_geometry(self.spec, bank._buckets):
                xs = self.req_views[w][:, :need]
                xs[:] = 0
                np.asarray(bank._wire_outputs(xs))
                n += 1
        return n

    def stop(self):
        if getattr(self, "_thread", None) is not None and self._thread.is_alive():
            self.req_q.put(None)
            self._thread.join(timeout=10)
        self._thread = None
        self.req_views = []
        self.resp_views = []
        for shm in getattr(self, "_shms", []):
            try:
                shm.close()
                shm.unlink()
            except Exception:
                pass
        self._shms = []


class ShardedDetectorBank:
    """Drop-in multi-process variant of :class:`DetectorBank`: lanes are
    sharded contiguously across ``n_workers`` processes that do all
    host-side staging, while this (parent) process serves every staged
    round on the one card. Same drain contract: ``drain()`` returns
    ``[n_lanes, n_max, outputs]`` with ``last_counts`` /
    ``last_sample_indices`` valid prefixes, gap/overflow accounting
    aggregates per lane, and results are bit-identical to a
    single-process ``DetectorBank`` fed the same stream (test-pinned:
    the wire staging, bucket ladder, and device programs are the exact
    same code on both sides).

    Intended for multi-core live hosts where one process's staging caps
    the lane count. Not thread-safe; drive from one thread.
    """

    def __init__(
        self,
        configs,
        n_workers: int = 2,
        max_buffer_seconds: float = 30.0,
        buckets: tuple | None = None,
        transfer_dtype: str = "float32",
        min_drain_hops: int = 1,
    ):
        if n_workers < 1 or n_workers > len(configs):
            raise ValueError(
                f"n_workers must be in [1, n_lanes]; got {n_workers} for "
                f"{len(configs)} lanes"
            )
        buckets = tuple(buckets) if buckets is not None else _DEFAULT_BUCKETS
        self.n_lanes = len(configs)
        self.spec = detector_spec_from_config(configs[0])[0]
        self.thresholds = np.asarray(
            [detector_spec_from_config(c)[0].thresholds[0] for c in configs],
            np.float64,
        )
        out_w = self.spec.net.outputs
        wire = transfer_dtype
        if wire not in WIRE_DTYPES:
            raise ValueError(f"unknown transfer_dtype {wire!r}")

        # contiguous near-equal shards
        base, extra = divmod(self.n_lanes, n_workers)
        sizes = [base + (1 if w < extra else 0) for w in range(n_workers)]
        self._offsets = np.concatenate([[0], np.cumsum(sizes)])
        self._sizes = sizes
        self.n_workers = n_workers

        self._closed = False
        shard_cfgs = [
            list(configs[self._offsets[w] : self._offsets[w + 1]])
            for w in range(n_workers)
        ]
        self._server = WireDeviceServer(
            shard_cfgs,
            buckets=buckets,
            transfer_dtype=wire,
            min_drain_hops=min_drain_hops,
        )
        ctx = self._server.ctx
        self._cmd_qs = [ctx.Queue() for _ in range(n_workers)]
        self._rep_qs = [ctx.Queue() for _ in range(n_workers)]
        self._workers = []
        bank_kwargs = dict(
            max_buffer_seconds=max_buffer_seconds,
            buckets=buckets,
            transfer_dtype=wire,
            min_drain_hops=min_drain_hops,
        )
        try:
            for w in range(n_workers):
                req_name, resp_name, req_shape, resp_shape = (
                    self._server.link_specs[w]
                )
                p = ctx.Process(
                    target=_worker_main,
                    args=(
                        w,
                        shard_cfgs[w],
                        bank_kwargs,
                        req_name,
                        resp_name,
                        req_shape,
                        resp_shape,
                        wire,
                        self._cmd_qs[w],
                        self._rep_qs[w],
                        self._server.req_q,
                        self._server.resp_qs[w],
                    ),
                    daemon=True,
                )
                p.start()
                self._workers.append(p)
        except Exception:
            self.close()
            raise

        self.last_counts = np.zeros(self.n_lanes, np.int64)
        self.last_sample_indices = [
            np.zeros(0, np.int64) for _ in range(self.n_lanes)
        ]
        self.last_outputs = np.zeros((self.n_lanes, out_w), np.float32)
        self.overflows = [0] * self.n_lanes
        self.dropped_samples = [0] * self.n_lanes
        self.hops_emitted = [0] * self.n_lanes
        self._server.start()

    def warm_up(self) -> int:
        """Compile every drain-bucket device program eagerly (one per
        bucket per shard). Call before wall-clock feeding, so no drain
        round waits on a compile."""
        return self._server.warm_up()

    # -- feeding (routed to the owning worker) ---------------------------

    def _worker_of(self, lane: int) -> tuple[int, int]:
        if not 0 <= lane < self.n_lanes:
            raise IndexError(f"lane {lane} out of range")
        w = int(np.searchsorted(self._offsets, lane, side="right") - 1)
        return w, lane - int(self._offsets[w])

    def append_audio_data(self, lane: int, samples: np.ndarray) -> None:
        """Queue samples for one lane (ships to the shard's worker; the
        worker's own bank applies buffer caps and overflow accounting).
        Unlike DetectorBank this cannot return the accepted/overflow
        bool synchronously — overflow totals aggregate on each drain."""
        w, local = self._worker_of(lane)
        self._cmd_qs[w].put(
            ("append", local, np.ascontiguousarray(samples, np.float32))
        )

    def note_gap(self, lane: int, n: int) -> None:
        w, local = self._worker_of(lane)
        self._cmd_qs[w].put(("gap", local, int(n)))

    # -- draining ---------------------------------------------------------

    def drain(self, flush: bool = False) -> np.ndarray:
        """Broadcast a drain to every worker (their staging overlaps
        across processes), serve their device rounds, and assemble the
        global ``[n_lanes, n_max, outputs]`` result + valid-prefix
        metadata exactly like DetectorBank.drain."""
        if self._closed:
            raise RuntimeError("bank is closed")
        for q in self._cmd_qs:
            q.put(("drain", flush))
        out_w = self.spec.net.outputs
        shard_replies = []
        for w in range(self.n_workers):
            r = self._get_reply(w)
            if r[0] == "err":
                raise RuntimeError(
                    f"worker {w} drain failed:\n{r[1]}"
                )
            shard_replies.append(r)
        counts = np.zeros(self.n_lanes, np.int64)
        for w, (_, c_w, idx_w, valid_w, ovf, drp, hops) in enumerate(
            shard_replies
        ):
            lo = int(self._offsets[w])
            counts[lo : lo + len(c_w)] = c_w
            for i, a in enumerate(idx_w):
                self.last_sample_indices[lo + i] = a
            self.overflows[lo : lo + len(ovf)] = ovf
            self.dropped_samples[lo : lo + len(drp)] = drp
            self.hops_emitted[lo : lo + len(hops)] = hops
        n_out = int(counts.max()) if self.n_lanes else 0
        result = np.zeros((self.n_lanes, n_out, out_w), np.float32)
        for w, (_, c_w, _idx, valid_w, *_rest) in enumerate(shard_replies):
            lo = int(self._offsets[w])
            pos = 0
            for i, c in enumerate(c_w):
                if c:
                    result[lo + i, :c] = valid_w[pos : pos + c]
                    self.last_outputs[lo + i] = valid_w[pos + c - 1]
                    pos += c
        self.last_counts = counts
        return result

    def worker_backends_initialized(self) -> list[bool]:
        """Whether each worker process has started a JAX backend. They
        must not: the parent owns the card."""
        for q in self._cmd_qs:
            q.put(("backends",))
        return [bool(self._get_reply(w)[1]) for w in range(self.n_workers)]

    def _get_reply(self, w: int):
        """Blocking reply read that notices a dead worker instead of
        hanging the parent forever (a worker that crashed hard — OOM
        kill, segfault in a native lib — leaves no ("err", ...) reply)."""
        while True:
            try:
                return self._rep_qs[w].get(timeout=1.0)
            except queue_mod.Empty:
                if not self._workers[w].is_alive():
                    raise RuntimeError(
                        f"worker {w} died (exitcode "
                        f"{self._workers[w].exitcode}) mid-drain"
                    ) from None

    def seen_syllables(self) -> np.ndarray:
        """Drain and OR detections per lane (same contract as
        DetectorBank.seen_syllables)."""
        outs = self.drain()
        if not outs.shape[1]:
            return np.zeros(self.n_lanes, bool)
        valid = np.arange(outs.shape[1])[None, :] < self.last_counts[:, None]
        hits = outs[:, :, 0] >= self.thresholds.astype(np.float32)[:, None]
        return np.any(hits & valid, axis=1)

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        if getattr(self, "_closed", True):
            return
        self._closed = True
        for q in getattr(self, "_cmd_qs", []):
            try:
                q.put(("stop",))
            except Exception:
                pass
        for p in getattr(self, "_workers", []):
            p.join(timeout=10)
            if p.is_alive():  # pragma: no cover - stuck-worker insurance
                p.terminate()
                p.join(timeout=5)
        if getattr(self, "_server", None) is not None:
            self._server.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):  # pragma: no cover - interpreter-exit best effort
        try:
            self.close()
        except Exception:
            pass
