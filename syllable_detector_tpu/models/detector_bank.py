"""Batched multi-channel streaming detector — the live deployment shape.

The reference runs one independent SyllableDetector object per audio
channel and drains them one at a time on the processing queue (reference:
SyllableDetector/Processor.swift:57-59, 128-149). On an accelerator that
serial per-lane drain wastes the device: every live channel's hop work is
a few kFLOP, so the only way to fill it is to evaluate ALL channels in one
program. :class:`DetectorBank` does exactly that — per-lane sample buffers
on the host, one jitted device program per drain round (wire
dequantization + the vmapped XLA pipeline of models/detector.offline_outputs)
evaluating every lane's new hops together, with per-channel DISTINCT
networks as stacked parameter pytrees.

Lanes progress INDEPENDENTLY, like the reference's per-channel drains
(Processor.swift:102-149, channels never wait on each other): a drain
evaluates the max over lanes of newly available hops in one padded batch
and each lane's valid prefix is reported via :attr:`last_counts` /
:attr:`last_sample_indices`. A dead or starved capture lane therefore
never stalls detection on the others.

Sample accounting is per lane and survives overflow: a chunk dropped at
the ``max_buffer_seconds`` cap advances the lane's stream clock and closes
the current contiguous segment (windows must not straddle missing audio),
so post-gap outputs carry their TRUE stream sample indices — the same
sample-accurate bookkeeping the reference's offline path keeps
(SyllableDetectorCLI/TrackDetector.swift:67-68). After a gap the lane
re-warms exactly like a fresh stream (first output at
``first_output_sample`` past the gap, TrackDetector.swift:38-42).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np

from syllable_detector_tpu.config.model_format import SyllableDetectorConfig
from syllable_detector_tpu.models.detector import (
    _FRAME_BUCKETS,
    deinterleave_frames,
    detector_spec_from_config,
    offline_outputs,
)
from syllable_detector_tpu.models.neural_net import stack_params
from syllable_detector_tpu.ops.stft import normalize_overlap, num_frames
from syllable_detector_tpu.ops.wire import MU as _MU, WIRE_DTYPES, dequantize

__all__ = ["DetectorBank"]

_mulaw_lut_cache: np.ndarray | None = None


def _mulaw_lut() -> np.ndarray:
    """64Ki int16-code -> int8 mu-law-code lookup table (index = s16 +
    32768). Encoding goes through the int16 wire's exact clip+round first,
    so a mulaw8 stream is a strict further quantization of the int16 one."""
    global _mulaw_lut_cache
    if _mulaw_lut_cache is None:
        v = np.arange(-32768, 32768, dtype=np.float64) / 32767.0
        np.clip(v, -1.0, 1.0, out=v)
        y = np.sign(v) * np.log1p(_MU * np.abs(v)) / np.log1p(_MU)
        _mulaw_lut_cache = np.rint(y * 127.0).astype(np.int8)
    return _mulaw_lut_cache


def mulaw_expand_np(codes: np.ndarray) -> np.ndarray:
    """NumPy reference of the on-device mu-law expansion (tests/oracles)."""
    y = codes.astype(np.float64) / 127.0
    return (np.sign(y) * (np.expm1(np.abs(y) * np.log1p(_MU)) / _MU)).astype(
        np.float32
    )


@dataclasses.dataclass
class _Segment:
    """One gap-free run of a lane's stream. ``start`` is the absolute
    sample index (in the lane's true stream) of ``data[0]``; it advances
    as drained hops are trimmed. ``closed`` segments precede a gap and can
    never be extended — their remaining evaluable hops drain out, then the
    segment is discarded.

    Appends land in ``pending`` (a chunk list) and are merged into
    ``data`` lazily by :meth:`consolidate` — concatenating per append
    would copy the whole accumulated segment every chunk, turning a
    small-chunk capture loop quadratic (~50 GB of memcpy to buffer 30 s
    of 64-sample chunks)."""

    start: int
    data: np.ndarray
    closed: bool = False
    pending: list = dataclasses.field(default_factory=list)
    pending_len: int = 0

    @property
    def total_len(self) -> int:
        return len(self.data) + self.pending_len

    def consolidate(self) -> np.ndarray:
        """Merge pending chunks into ``data`` (one concatenate) and
        return it — call before reading sample contents."""
        if self.pending:
            self.data = np.concatenate([self.data, *self.pending])
            self.pending.clear()
            self.pending_len = 0
        return self.data


class DetectorBank:
    """N streaming detectors drained together in one device program.

    ``configs``: one per lane; all must share the first lane's pipeline
    geometry (thresholds may differ per lane — they are applied per lane).

    ``max_buffer_seconds`` bounds each lane's sample buffer. Appends
    beyond the cap are counted in ``overflows[lane]``, their length is
    added to ``dropped_samples[lane]``, and the lane's stream clock still
    advances — see :meth:`note_gap` (the reference fatalErrors instead,
    CircularShortTimeFourierTransform.swift:199).

    After each :meth:`drain`:

    * ``last_counts[lane]`` — how many of the returned rows are valid for
      that lane (the rest is padding);
    * ``last_sample_indices[lane]`` — absolute stream sample index of each
      valid output (TrackDetector.swift:67-68 accounting, per lane).
    """

    def __init__(
        self,
        configs: list[SyllableDetectorConfig],
        max_buffer_seconds: float = 30.0,
        pairs=None,
        buckets: tuple | None = None,
        transfer_dtype: str = "float32",
        min_drain_hops: int = 1,
    ):
        if not configs:
            raise ValueError("DetectorBank needs at least one lane")
        self.configs = list(configs)
        # pairs: precomputed [(spec, params)] matching configs — callers
        # that already built them (Processor's geometry grouping) skip a
        # second full weight-pytree construction per lane
        if pairs is None:
            pairs = [detector_spec_from_config(c) for c in self.configs]
        elif len(pairs) != len(self.configs):
            raise ValueError("pairs must match configs one-to-one")
        self.spec = pairs[0][0]
        base = dataclasses.replace(self.spec, thresholds=())
        for s, _ in pairs[1:]:
            if dataclasses.replace(s, thresholds=()) != base:
                raise ValueError(
                    "all lanes must share the first network's geometry "
                    "(sampling rate, FFT/window, band, layer sizes)"
                )
        self.params_list = [p for _, p in pairs]
        self.thresholds = np.asarray(
            [s.thresholds[0] for s, _ in pairs], np.float64
        )
        self.n_lanes = len(configs)
        self.max_buffer_samples = int(
            max_buffer_seconds * self.spec.sampling_rate
        )
        self.overflows = [0] * self.n_lanes
        self.dropped_samples = [0] * self.n_lanes
        self._stacked = None  # device-side stacked nets, built on first use
        self._segments: list[list[_Segment]] = [[] for _ in configs]
        self._offered = [0] * self.n_lanes  # absolute per-lane stream clock
        self.hops_emitted = [0] * self.n_lanes
        self.last_counts = np.zeros(self.n_lanes, np.int64)
        self.last_sample_indices: list[np.ndarray] = [
            np.zeros(0, np.int64) for _ in configs
        ]
        self.last_outputs = np.zeros(
            (self.n_lanes, self.spec.net.outputs), np.float32
        )
        # drain-shape ladder: each bucket is one compiled device shape, so
        # live deployments can pin a SUBSET to bound the compile budget —
        # e.g. buckets=(128,) compiles ONE shape per lane count; backlogs
        # beyond it drain in multiple rounds, and smaller backlogs pad up
        # (padding costs device compute; transfers and host assembly
        # scale with the VALID samples)
        if buckets is None:
            self._buckets = _FRAME_BUCKETS
        else:
            self._buckets = tuple(int(b) for b in buckets)
            if not self._buckets or any(
                b <= 0 for b in self._buckets
            ) or list(self._buckets) != sorted(set(self._buckets)):
                raise ValueError(
                    "buckets must be strictly increasing positive ints"
                )
        # wire format for the per-drain [n_lanes, need] device transfer
        # (ops/wire.py): 'int16' halves the host->device bytes by sending
        # capture-native PCM and dequantizing ON DEVICE. Semantically it
        # clips to [-1, 1] and rounds to 1/32767 steps — exactly the
        # precision of S16 capture hardware, so an int16-sourced stream
        # roundtrips EXACTLY (test-pinned); float-sourced streams see
        # <=3.1e-5 input error. 'mulaw8' QUARTERS the bytes (continuous
        # mu-law companding, mu=255, 8-bit codes; encode via a 64Ki
        # int16->int8 LUT on the host, expand ON DEVICE with one
        # elementwise exp). It is a LOSSY opt-in tier: <=3.5e-4 absolute
        # input error near zero, <=2.3% of |x| across the range (the
        # 127-level mu-law half step, ~ln(256)/254 relative) — measured
        # detector-output error on representative audio is test-pinned.
        # Use it when the host->device link, not fidelity, bounds lane
        # count.
        if transfer_dtype not in WIRE_DTYPES:
            raise ValueError(
                f"unknown transfer_dtype {transfer_dtype!r}; "
                "use 'float32', 'int16' or 'mulaw8'"
            )
        self.transfer_dtype = transfer_dtype
        # transfer efficiency floor: a drain round always sends a whole
        # bucket-shaped [n_lanes, need] staging transfer, so draining a
        # 5-hop tail through a 128-hop bucket pays ~25x the bytes the tail
        # is worth. min_drain_hops > 1 leaves sub-threshold tails buffered
        # for the next round (they are at most one batching window late);
        # closed (pre-gap) front segments drain regardless — their avail
        # can never grow, and post-gap audio queues behind them.
        self.min_drain_hops = int(min_drain_hops)
        # trailing partial interleaved frame awaiting its next capture
        # chunk (append_interleaved_audio_data)
        self._interleave_rem = np.zeros(0, np.float32)
        # reusable per-bucket staging buffers for the [n_lanes, need]
        # drain assembly: a fresh np.zeros per drain round memsets
        # n_lanes*need floats (75 MB at 1024 lanes / bucket 128) before a
        # single sample is copied — at live drain rates that memset alone
        # is a measurable slice of the hop budget. Each buffer remembers
        # how far every lane row was filled last round so only the stale
        # tail [m:prev_m) is re-zeroed (O(changed), not O(buffer)).
        self._stage: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        # native drain staging: ONE C call quantizes+assembles the whole
        # round instead of ~6 numpy dispatches per lane. Falls back to the
        # numpy loop when the native lib is unavailable (bit-identical
        # staging either way, test-pinned).
        from syllable_detector_tpu.runtime.ring_buffer import DrainStager

        stager = DrainStager(self.n_lanes)
        self._stager = stager if stager.available else None

    # -- feeding ------------------------------------------------------------

    def buffered_samples(self, lane: int) -> int:
        """Samples currently buffered (across segments) for one lane."""
        return sum(s.total_len for s in self._segments[lane])

    def append_audio_data(self, lane: int, samples: np.ndarray) -> bool:
        """Buffer a chunk for one lane. Returns False when the chunk was
        DROPPED at the ``max_buffer_seconds`` cap (counted in
        ``overflows``/``dropped_samples``; the lane's stream clock still
        advances so later timestamps stay sample-accurate)."""
        samples = np.asarray(samples, np.float32).reshape(-1)
        n = len(samples)
        if self.buffered_samples(lane) + n > self.max_buffer_samples:
            self.note_gap(lane, n)
            return False
        segs = self._segments[lane]
        if segs and not segs[-1].closed:
            # O(chunk): queue the copy in pending; drain consolidates once
            segs[-1].pending.append(samples.copy())
            segs[-1].pending_len += n
        else:
            segs.append(_Segment(start=self._offered[lane], data=samples.copy()))
        self._offered[lane] += n
        return True

    def append_interleaved_audio_data(self, samples: np.ndarray) -> list[bool]:
        """Fan an interleaved ``n_lanes``-channel capture buffer out to the
        lanes (frame-major, the layout Linux capture APIs deliver) — the
        bank-level counterpart of the reference's appendInterleavedData
        (CircularShortTimeFourierTransform.swift:203-217). Returns each
        lane's :meth:`append_audio_data` accept/drop flag.

        A trailing PARTIAL frame (buffer length not a multiple of
        ``n_lanes`` — a short read or an xrun boundary) is retained and
        prepended to the next call: silently discarding it would shift
        the affected lanes' stream clocks early with no gap accounting."""
        frames, self._interleave_rem = deinterleave_frames(
            samples, self._interleave_rem, self.n_lanes
        )
        return [
            self.append_audio_data(lane, np.ascontiguousarray(frames[:, lane]))
            for lane in range(self.n_lanes)
        ]

    def note_gap(self, lane: int, n: int) -> None:
        """Register ``n`` samples of the lane's stream as LOST (an
        overflow drop, or an externally observed capture gap): advance the
        stream clock so subsequent outputs keep true sample indices, and
        close the open segment — a window must never straddle missing
        audio, so the lane re-warms on the far side of the gap exactly
        like a fresh stream (TrackDetector.swift:38-42 accounting)."""
        self.overflows[lane] += 1
        self.dropped_samples[lane] += n
        self._offered[lane] += n
        segs = self._segments[lane]
        if segs and not segs[-1].closed:
            segs[-1].closed = True

    def note_interleaved_gap(self, n: int) -> None:
        """Register a capture gap observed on the INTERLEAVED stream
        feeding all lanes (``n`` interleaved samples lost): every lane
        loses ``n // n_lanes`` samples (capture devices drop whole
        frames), and the pending partial frame from
        :meth:`append_interleaved_audio_data` is discarded — it is
        pre-gap audio, and prepending it to the post-gap stream would mix
        audio across the gap and shift the de-interleave framing. The
        lanes whose carried sample is discarded get it counted into their
        gap so stream clocks stay sample-accurate."""
        per_lane = n // self.n_lanes
        rem_len = len(self._interleave_rem)
        self._interleave_rem = np.zeros(0, np.float32)
        for lane in range(self.n_lanes):
            self.note_gap(lane, per_lane + (1 if lane < rem_len else 0))

    # -- draining -----------------------------------------------------------

    def _front_avail(self, lane: int) -> int:
        """Evaluable hops of the lane's FRONT segment, discarding
        exhausted closed segments first."""
        spec = self.spec
        t = spec.time_range
        segs = self._segments[lane]
        while segs:
            front = segs[0]
            f = num_frames(front.total_len, spec.window_length, spec.window_overlap)
            avail = max(0, f - (t - 1))
            if avail or not front.closed:
                return avail
            segs.pop(0)  # closed and drained dry: the gap follows
        return 0

    def drain(self, flush: bool = False) -> np.ndarray:
        """Evaluate every lane's newly available hops in one padded
        batched device call per bucket round -> [n_lanes, n_max, outputs]
        (n_max may be 0). Lanes progress independently: row counts beyond
        ``last_counts[lane]`` are zero padding, and
        ``last_sample_indices[lane]`` gives each valid output's absolute
        stream sample index. ``flush=True`` ignores ``min_drain_hops``
        (end-of-stream: evaluate every last buffered hop).

        Each segment retains the trailing ``(timeRange-1)`` hops of samples so the next drain's evaluations
        continue exactly where this one stopped; batch lengths bucket to
        the shared _FRAME_BUCKETS sizes so device kernels compile once per
        bucket.
        """
        spec = self.spec
        t = spec.time_range
        hop = spec.hop
        gap, _ = normalize_overlap(spec.window_overlap)
        out_w = spec.net.outputs
        first_out = spec.first_output_sample

        per_lane_outs: list[list[np.ndarray]] = [[] for _ in range(self.n_lanes)]
        per_lane_idx: list[list[np.ndarray]] = [[] for _ in range(self.n_lanes)]

        i16 = self.transfer_dtype == "int16"
        mu8 = self.transfer_dtype == "mulaw8"
        while True:
            avail = [self._front_avail(i) for i in range(self.n_lanes)]
            n_max = max(avail)
            if n_max <= 0:
                break
            if not flush and n_max < self.min_drain_hops and not any(
                a > 0 and self._segments[i][0].closed
                for i, a in enumerate(avail)
            ):
                break  # defer the tail; nothing urgent (no closed fronts)
            take = min(n_max, self._buckets[-1])
            bucket = next(b for b in self._buckets if b >= take)
            need = (bucket + t - 2) * hop + gap + spec.window_length
            if need in self._stage:
                xs, prev = self._stage[need]
            else:
                xs = np.zeros(
                    (self.n_lanes, need), WIRE_DTYPES[self.transfer_dtype]
                )
                prev = np.zeros(self.n_lanes, np.int64)
                self._stage[need] = (xs, prev)
            stager = self._stager
            if stager is not None:
                # native fast path: gather per-lane pointers, then one C
                # call stages+quantizes the whole round. `keep` binds the
                # source arrays through the call (the ctypes lifetime
                # trap: a bare .ctypes.data int does not keep its array
                # alive).
                ptrs, lens = stager.ptrs, stager.lens
                keep = []
                for i in range(self.n_lanes):
                    if avail[i] <= 0:
                        lens[i] = 0
                        continue
                    data = self._segments[i][0].consolidate()
                    if not data.flags.c_contiguous:
                        data = np.ascontiguousarray(data)
                    keep.append(data)
                    ptrs[i] = data.ctypes.data
                    lens[i] = len(data)
                stager.stage(
                    xs,
                    prev,
                    2 if mu8 else 1 if i16 else 0,
                    _mulaw_lut().ctypes.data if mu8 else 0,
                    keepalive=keep,
                )
            else:
                for i in range(self.n_lanes):
                    if avail[i] <= 0:
                        m = 0
                    else:
                        data = self._segments[i][0].consolidate()
                        m = min(len(data), need)
                        if i16 or mu8:
                            # capture-native PCM wire: clip + round-to-
                            # nearest, exactly what S16 capture hardware
                            # does
                            q = np.clip(data[:m], -1.0, 1.0)
                            q *= np.float32(32767.0)
                            np.rint(q, out=q)
                            if mu8:
                                # compand s16 codes to 8-bit via the LUT
                                xs[i, :m] = _mulaw_lut()[
                                    q.astype(np.int32) + 32768
                                ]
                            else:
                                xs[i, :m] = q
                        else:
                            xs[i, :m] = data[:m]
                    if m < prev[i]:
                        xs[i, m : prev[i]] = 0
                    prev[i] = m
            outs = np.asarray(self._wire_outputs(xs))[:, :take]
            for i in range(self.n_lanes):
                take_i = min(avail[i], take)
                if take_i <= 0:
                    continue
                front = self._segments[i][0]
                per_lane_outs[i].append(outs[i, :take_i])
                per_lane_idx[i].append(
                    front.start + first_out + hop * np.arange(take_i, dtype=np.int64)
                )
                rem = front.data[take_i * hop :]
                # a small view would pin the whole pre-drain buffer (its
                # base array) until the next append; copy once the
                # remainder is under half the base so an idle/dead lane
                # releases megabytes instead of stranding them
                base = rem.base if rem.base is not None else rem
                front.data = rem.copy() if rem.nbytes * 2 < base.nbytes else rem
                front.start += take_i * hop
                self.hops_emitted[i] += take_i

        counts = np.array([sum(len(o) for o in per_lane_outs[i]) for i in range(self.n_lanes)], np.int64)
        n_out = int(counts.max()) if self.n_lanes else 0
        result = np.zeros((self.n_lanes, n_out, out_w), np.float32)
        for i in range(self.n_lanes):
            if counts[i]:
                lane_rows = np.concatenate(per_lane_outs[i], axis=0)
                result[i, : counts[i]] = lane_rows
                self.last_outputs[i] = lane_rows[-1]
            self.last_sample_indices[i] = (
                np.concatenate(per_lane_idx[i])
                if per_lane_idx[i]
                else np.zeros(0, np.int64)
            )
        self.last_counts = counts
        return result

    def _wire_outputs(self, xs_np):
        """Device transfer + batched evaluation of one staged drain round:
        ONE jitted program (wire dequantization + the vmapped pipeline)
        per bucket shape."""
        if self._stacked is None:
            self._stacked = stack_params(self.params_list)
        return _bank_program(
            self.spec, self.transfer_dtype, self._stacked, xs_np
        )

    def seen_syllables(self) -> np.ndarray:
        """Drain and OR detections per lane (output 0 vs each lane's own
        threshold) -> bool[n_lanes] (SyllableDetector.swift:220-230, per
        lane). Only each lane's valid prefix is consulted — padding rows
        never count."""
        outs = self.drain()
        if not outs.shape[1]:
            return np.zeros(self.n_lanes, bool)
        valid = np.arange(outs.shape[1])[None, :] < self.last_counts[:, None]
        # float32 comparison, like Detector.seen_syllable
        hits = outs[:, :, 0] >= self.thresholds.astype(np.float32)[:, None]
        return np.any(hits & valid, axis=1)

    # -- state checkpoint / resume (mirrors Detector.get_state/set_state) ---

    def get_state(self) -> dict:
        """Snapshot every lane's streaming state as plain numpy arrays."""
        return {
            "segments": [
                [
                    (int(s.start), s.consolidate().copy(), bool(s.closed))
                    for s in segs
                ]
                for segs in self._segments
            ],
            "offered": list(self._offered),
            "hops_emitted": list(self.hops_emitted),
            "last_outputs": np.asarray(self.last_outputs, np.float32).copy(),
            "last_counts": np.asarray(self.last_counts, np.int64).copy(),
            "last_sample_indices": [
                a.copy() for a in self.last_sample_indices
            ],
            "overflows": list(self.overflows),
            "dropped_samples": list(self.dropped_samples),
            "interleave_rem": self._interleave_rem.copy(),
        }

    def set_state(self, state: dict) -> None:
        """Restore a :meth:`get_state` snapshot (possibly in a different
        process); continuing the streams afterwards produces exactly the
        outputs an uninterrupted bank would."""
        # legacy (round-3) lockstep frame counter; 0 under the new schema,
        # where it only backstops snapshots missing offered/hops_emitted
        legacy_fs = int(state.get("frames_seen", 0))
        if "segments" in state:
            segments = [
                [
                    _Segment(int(st), np.asarray(d, np.float32).copy(), bool(c))
                    for st, d, c in segs
                ]
                for segs in state["segments"]
            ]
        else:  # legacy (round-3) single-residual schema: a LOCKSTEP
            # frames_seen counter and one residual per lane. Each emitted
            # hop trimmed ``hop`` samples off the residual front, so
            # residual[0] sits at absolute stream sample
            # frames_seen * hop — restore the segment start and per-lane
            # hop counters from it, or the stream clock rewinds to 0 and
            # post-restore sample indices duplicate pre-crash ones.
            start0 = legacy_fs * self.spec.hop
            segments = [
                [_Segment(start0, np.asarray(r, np.float32).copy())]
                if len(np.asarray(r).reshape(-1))
                else []
                for r in state["residuals"]
            ]
        if len(segments) != self.n_lanes:
            raise ValueError(
                f"state has {len(segments)} lanes, bank has {self.n_lanes}"
            )
        self._segments = segments
        self._offered = [
            int(v)
            for v in state.get(
                "offered",
                [
                    (segs[-1].start + len(segs[-1].data))
                    if segs
                    else legacy_fs * self.spec.hop
                    for segs in segments
                ],
            )
        ]
        self.hops_emitted = [
            int(v)
            for v in state.get("hops_emitted", [legacy_fs] * self.n_lanes)
        ]
        self.last_outputs = np.asarray(state["last_outputs"], np.float32).copy()
        # last drain's per-lane progress: restore from the snapshot, or
        # RESET when absent — stale values from this process's previous
        # stream would attribute the old lane progress/sample indices to
        # the restored one
        self.last_counts = np.asarray(
            state.get("last_counts", np.zeros(self.n_lanes, np.int64)),
            np.int64,
        ).copy()
        lsi = state.get("last_sample_indices")
        self.last_sample_indices = (
            [np.asarray(a, np.int64).copy() for a in lsi]
            if lsi is not None
            else [np.zeros(0, np.int64) for _ in range(self.n_lanes)]
        )
        self.overflows = list(state.get("overflows", [0] * self.n_lanes))
        self.dropped_samples = list(
            state.get("dropped_samples", [0] * self.n_lanes)
        )
        self._interleave_rem = np.asarray(
            state.get("interleave_rem", np.zeros(0, np.float32)), np.float32
        ).copy()

    def save_state(self, path) -> None:
        state = self.get_state()
        arrays = {}
        seg_counts = []
        for i, segs in enumerate(state["segments"]):
            seg_counts.append(len(segs))
            arrays[f"seg_starts_{i}"] = np.asarray(
                [s[0] for s in segs], np.int64
            )
            arrays[f"seg_closed_{i}"] = np.asarray(
                [s[2] for s in segs], bool
            )
            for k, (_, d, _) in enumerate(segs):
                arrays[f"seg_data_{i}_{k}"] = d
        for i, a in enumerate(state["last_sample_indices"]):
            arrays[f"lsi_{i}"] = a
        np.savez(
            path,
            n_lanes=self.n_lanes,
            seg_counts=np.asarray(seg_counts, np.int64),
            offered=np.asarray(state["offered"], np.int64),
            hops_emitted=np.asarray(state["hops_emitted"], np.int64),
            last_outputs=state["last_outputs"],
            last_counts=state["last_counts"],
            overflows=np.asarray(state["overflows"], np.int64),
            dropped_samples=np.asarray(state["dropped_samples"], np.int64),
            interleave_rem=state["interleave_rem"],
            **arrays,
        )

    def load_state(self, path) -> None:
        with np.load(path) as data:
            if "seg_counts" in data.files:
                segments = []
                for i, n in enumerate(data["seg_counts"]):
                    starts = data[f"seg_starts_{i}"]
                    closed = data[f"seg_closed_{i}"]
                    segments.append(
                        [
                            (int(starts[k]), data[f"seg_data_{i}_{k}"], bool(closed[k]))
                            for k in range(int(n))
                        ]
                    )
                state = {
                    "segments": segments,
                    "offered": list(data["offered"]),
                    "hops_emitted": list(data["hops_emitted"]),
                    "last_outputs": data["last_outputs"],
                    "overflows": list(data["overflows"]),
                    "dropped_samples": list(data["dropped_samples"]),
                    "interleave_rem": (
                        data["interleave_rem"]
                        if "interleave_rem" in data.files
                        else np.zeros(0, np.float32)
                    ),
                }
                if "last_counts" in data.files:
                    state["last_counts"] = data["last_counts"]
                    state["last_sample_indices"] = [
                        data[f"lsi_{i}"]
                        for i in range(int(data["n_lanes"]))
                    ]
                self.set_state(state)
                return
            # legacy (round-3) npz layout
            n_saved = sum(1 for k in data.files if k.startswith("residual_"))
            self.set_state(
                {
                    "residuals": [
                        data[f"residual_{i}"] for i in range(n_saved)
                    ],
                    "frames_seen": int(data["frames_seen"]),
                    "last_outputs": data["last_outputs"],
                    "overflows": list(data["overflows"]),
                }
            )

    def warm_up(self, buckets: tuple | None = None) -> int:
        """Eagerly compile every batched drain shape (one per bucket —
        this bank's pinned ladder by default), through the same wire
        path drains take."""
        spec = self.spec
        gap, _ = normalize_overlap(spec.window_overlap)
        n = 0
        dtype = WIRE_DTYPES[self.transfer_dtype]
        for b in buckets if buckets is not None else self._buckets:
            need = (b + spec.time_range - 2) * spec.hop + gap + spec.window_length
            out = self._wire_outputs(np.zeros((self.n_lanes, need), dtype))
            jax.block_until_ready(out)
            n += 1
        return n


@functools.partial(jax.jit, static_argnames=("spec", "wire"))
def _bank_program(spec, wire: str, stacked, xs):
    """[lanes, n] wire codes + stacked per-lane nets -> [lanes, E, outputs]."""
    x = dequantize(xs, wire)
    return jax.vmap(lambda p, v: offline_outputs(spec, p, v))(stacked, x)
