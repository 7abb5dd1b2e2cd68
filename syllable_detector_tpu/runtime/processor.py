"""Live multi-channel pipeline orchestration.

Re-implements the reference's Processor hierarchy (reference:
SyllableDetector/Processor.swift:13-295): one detector per configured entry,
fan-out from the audio input callback, lock-free ring handoff from the
capture thread to a serial processing worker (the reference's GCD queue,
Processor.swift:82, 128), per-channel input-RMS and max-output stats
(:69-76, 111-113, 138), and a pluggable output backend fired once per
callback-drain with "seen syllable" (:151, 187-226, 228-294):

  * ProcessorAudio -> :class:`AudioTTLOutput` — 1 ms high pulse on the paired
    output channel (Processor.swift:192, 217-225)
  * ProcessorArduino -> :class:`ArduinoTTLOutput` — digital write on pin
    7 + channel with a 20-hop hold refreshed on retrigger
    (Processor.swift:233, 266-293)

The capture thread only produces into the native SPSC ring; all detector
math runs on the worker, exactly the reference's produce/consume split over
TPCircularBuffer.
"""

from __future__ import annotations

import math
import queue
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from syllable_detector_tpu.config.model_format import SyllableDetectorConfig
from syllable_detector_tpu.models.detector import Detector
from syllable_detector_tpu.ops.resample import (
    LinearResamplerState,
    linear_resample_chunk_exact,
    linear_resample_init,
)
from syllable_detector_tpu.runtime.arduino import ArduinoIO, ArduinoPin
from syllable_detector_tpu.runtime.audio_io import (
    AudioInputInterface,
    AudioOutputInterface,
)
from syllable_detector_tpu.runtime.ring_buffer import RingBuffer
from syllable_detector_tpu.utils.stats import StatMax, SummaryStat
from syllable_detector_tpu.utils.timing import Time
from time import perf_counter_ns as _time_ns

__all__ = [
    "ProcessorEntry",
    "Processor",
    "AudioTTLOutput",
    "ArduinoTTLOutput",
    "CallbackOutput",
    "csv_event_log",
]


def csv_event_log(fh):
    """A :class:`Processor` ``event_log`` sink writing the offline CLI's
    CSV contract — ``channel,sample,seconds,out0[,out1…]``
    (main.swift:31-40, same float formatting) — for LIVE detections, so a
    closed-loop session leaves the same record an offline re-scan would
    (modulo the live output-0 criterion and no debounce). Flushes per row:
    an experiment crash must not lose buffered events."""
    from syllable_detector_tpu.utils.fmt import fmt_double, fmt_float32

    def log(channel, sample, seconds, outputs):
        row = f"{channel},{sample},{fmt_double(seconds)}"
        for v in outputs:
            row += f",{fmt_float32(v)}"
        fh.write(row + "\n")
        fh.flush()

    return log


@dataclass
class ProcessorEntry:
    """One input-channel -> detector -> output-channel lane
    (Processor.swift:13-24)."""

    input_channel: int
    output_channel: int
    config: Optional[SyllableDetectorConfig] = None
    network: str = ""
    resample_from: Optional[float] = None  # device rate if != net rate


class OutputBackend:
    def set_up(self, entries: list[ProcessorEntry]) -> None:
        pass

    def tear_down(self) -> None:
        pass

    def prepare_output(self, index: int, entry: ProcessorEntry, seen: bool) -> None:
        raise NotImplementedError


class AudioTTLOutput(OutputBackend):
    """1 ms high pulse on the entry's output channel
    (Processor.swift:187-226)."""

    HIGH_DURATION = 0.001  # Processor.swift:192

    def __init__(self, interface: AudioOutputInterface):
        self.interface = interface

    def set_up(self, entries: list[ProcessorEntry]) -> None:
        self.interface.initialize_audio()

    def tear_down(self) -> None:
        self.interface.tear_down_audio()

    def prepare_output(self, index: int, entry: ProcessorEntry, seen: bool) -> None:
        if seen:
            self.interface.create_high_output(entry.output_channel, self.HIGH_DURATION)


class ArduinoTTLOutput(OutputBackend):
    """Pin 7+channel digital write with a 20-drain hold counter
    (Processor.swift:228-294)."""

    HIGH_STEPS = 20  # Processor.swift:233

    def __init__(self, arduino: ArduinoIO):
        self.arduino = arduino
        self._high_count: list[int] = []

    def set_up(self, entries: list[ProcessorEntry]) -> None:
        self._high_count = [0] * len(entries)
        for e in entries:
            self.arduino.set_pin_mode(7 + e.output_channel, ArduinoPin.OUTPUT)

    def prepare_output(self, index: int, entry: ProcessorEntry, seen: bool) -> None:
        if seen:
            if self._high_count[index] == 0:
                self.arduino.write_digital(7 + entry.output_channel, True)
            self._high_count[index] = self.HIGH_STEPS
        elif self._high_count[index] > 0:
            self._high_count[index] -= 1
            if self._high_count[index] == 0:
                self.arduino.write_digital(7 + entry.output_channel, False)


class CallbackOutput(OutputBackend):
    """Invoke a Python callable per drain; base for file/log sinks."""

    def __init__(self, fn):
        self.fn = fn

    def prepare_output(self, index: int, entry: ProcessorEntry, seen: bool) -> None:
        self.fn(index, entry, seen)


@dataclass
class _Lane:
    entry: ProcessorEntry
    detector: Optional[Detector]  # None in batched-drain mode
    ring: RingBuffer
    resampler: Optional[LinearResamplerState]
    stat_input: SummaryStat
    stat_output: SummaryStat
    detections: int = 0
    overflows: int = 0  # dropped buffers (the reference fatalErrors instead,
    # CircularShortTimeFourierTransform.swift:199). Written ONLY by the
    # capture thread; the worker's bank-cap drops count in bank_overflows
    # (a lone += from each thread — a shared field would lose increments
    # across the two threads' read-modify-writes)
    dropped_samples: int = 0  # total samples lost in those drops
    bank_overflows: int = 0  # worker-thread only: bank max_buffer drops
    bank_dropped_samples: int = 0
    last_audio_ns: Optional[int] = None  # monotonic stamp of the last
    # capture callback — a dead/unplugged mic shows as a growing age
    # (the reference's GUI shows per-channel RMS going quiet instead,
    # ViewControllerProcessor.swift:278-284)
    # -- gap bookkeeping between the two threads ---------------------------
    # A ring-overflow drop leaves a hole in the lane's stream that the
    # detector/bank must know about (windows must never straddle missing
    # audio, and sample indices must stay true). The capture thread
    # records each drop as (produced_samples at drop time, n dropped);
    # the worker splices the gap into the stream at exactly that
    # position while feeding consumed ring samples (list.append /
    # prefix-del are GIL-atomic, so no lock is needed).
    produced_samples: int = 0  # capture thread: samples produced into ring
    appended_samples: int = 0  # worker: consumed samples fed to the sink
    gap_events: list = field(default_factory=list)  # capture appends; worker acks
    gap_acked: int = 0  # worker: index of the first un-acked gap event
    capture_gaps: int = 0  # capture thread: device-side losses (xruns)
    capture_lost_samples: int = 0  # lane-rate samples lost device-side
    # -- per-lane stream clock (worker thread; event-log timestamps) -------
    # Mirrors TrackDetector.swift:38-42,67-68 accounting for the PER-LANE
    # drain mode: output k of the current contiguous segment ends at
    # stream sample segment_start + first_output_sample + k*hop. Gaps
    # close the segment and advance the clock (batched mode gets the same
    # numbers from DetectorBank.last_sample_indices).
    segment_start: int = 0  # stream position where the current segment began
    segment_fed: int = 0  # samples fed to the detector since segment start
    evals_done: int = 0  # outputs drained since segment start


class Processor:
    """ProcessorBase equivalent (Processor.swift:34-185).

    ``batched=True`` replaces the per-lane Detector drains with
    :class:`~syllable_detector_tpu.models.detector_bank.DetectorBank`
    calls evaluating lanes' new hops together in one device program (with
    per-channel distinct networks) — the batched shape for many live
    channels, where the reference drains detectors serially on its GCD
    queue (Processor.swift:128-149). Lanes are GROUPED by pipeline
    geometry, one bank per group, so mixed-geometry deployments batch
    within each compatible group.
    """

    def __init__(
        self,
        interface_input: AudioInputInterface,
        entries: list[ProcessorEntry],
        output: OutputBackend,
        ring_seconds: float = 10.0,
        batched: bool = False,
        event_log=None,
        bank_buffer_seconds: float = 30.0,
        bank_buckets: Optional[tuple] = None,
        bank_transfer_dtype: str = "float32",
        bank_min_drain_hops: int = 1,
        drain_interval: float = 0.0,
    ):
        self.entries = [e for e in entries if e.config is not None]
        self.output = output
        self.interface_input = interface_input
        # optional detection event sink, called from the worker thread as
        # event_log(input_channel, sample_index, seconds, outputs_row) for
        # every detection (outputs[0] >= thresholds[0], the live criterion,
        # Processor.swift:27-31) with the SAME sample-accurate stream
        # indices the offline CLI prints (TrackDetector.swift:67-68) —
        # gaps (ring/bank/device losses) keep the clock true. See
        # csv_event_log for the CLI-format CSV sink.
        self.event_log = event_log

        # batched mode: lanes GROUPED by pipeline geometry, one DetectorBank
        # per group — mixed-geometry deployments (the GUI loads arbitrary
        # nets per row, ViewControllerProcessor.swift:222-276) still batch
        # within each compatible group
        self._banks: list = []  # (DetectorBank, [lane indices])
        self._bank = None  # the single-group convenience alias
        if batched and self.entries:
            import dataclasses

            from syllable_detector_tpu.models.detector import (
                detector_spec_from_config,
            )
            from syllable_detector_tpu.models.detector_bank import DetectorBank

            groups: dict = {}
            pairs = [detector_spec_from_config(e.config) for e in self.entries]
            for i, (spec_i, _p) in enumerate(pairs):
                key = dataclasses.replace(spec_i, thresholds=())
                groups.setdefault(key, []).append(i)
            for idxs in groups.values():
                bank = DetectorBank(
                    [self.entries[i].config for i in idxs],
                    pairs=[pairs[i] for i in idxs],  # no double spec build
                    # live deployment knobs (see DetectorBank): a bounded
                    # backlog cap keeps the worst catch-up drain inside the
                    # warmed bucket ladder; a pinned ladder bounds the
                    # compile budget to one shape per bucket; the int16
                    # wire halves per-drain transfer bytes
                    max_buffer_seconds=bank_buffer_seconds,
                    buckets=bank_buckets,
                    transfer_dtype=bank_transfer_dtype,
                    min_drain_hops=bank_min_drain_hops,
                )
                self._banks.append((bank, idxs))
            if len(self._banks) == 1:
                self._bank = self._banks[0][0]

        self._lanes: list[_Lane] = []
        for e in self.entries:
            rate = e.config.sampling_rate
            ring = RingBuffer(int(ring_seconds * rate))
            resampler = None
            if e.resample_from is not None and abs(e.resample_from - rate) > 1.0:
                # resampler only when rates differ by > 1 Hz
                # (ViewControllerProcessor.swift:247-250)
                resampler = linear_resample_init(e.resample_from, rate)
            self._lanes.append(
                _Lane(
                    entry=e,
                    detector=None if self._banks else Detector(e.config),
                    ring=ring,
                    resampler=resampler,
                    stat_input=SummaryStat(StatMax()),
                    stat_output=SummaryStat(StatMax()),
                )
            )

        # channel -> lane index map (Processor.swift:62-66)
        max_ch = max((e.input_channel for e in self.entries), default=-1)
        self._channels = [-1] * (1 + max_ch)
        for i, e in enumerate(self.entries):
            self._channels[e.input_channel] = i

        self._work: "queue.Queue[int]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # batched-mode batching window: coalesce capture chunks for up to
        # this long between bank drains. Transfer-bound live deployments
        # (many lanes over a narrow host->device link) trade detection
        # latency for bandwidth: each drain resends a fixed
        # (time_range-2)*hop + window context per lane, so longer windows
        # amortize it toward the raw realtime byte rate
        self._drain_interval = float(drain_interval)
        self._last_drain = 0.0
        self.drain_errors = 0  # transient per-drain failures survived
        self.output_errors = 0  # output-backend write failures survived

        # one-native-call block produce across all lanes (fan-out hot
        # path); only usable when every device channel maps to a lane at
        # device rate — resampled rows change length, so those deployments
        # take the per-lane loop in receive_audio_block instead
        self._block_writer = None
        if self._channels and all(i >= 0 for i in self._channels) and all(
            self._lanes[i].resampler is None for i in self._channels
        ):
            from syllable_detector_tpu.runtime.ring_buffer import (
                RingBlockWriter,
            )

            self._block_writer = RingBlockWriter(
                [self._lanes[i].ring for i in self._channels]
            )

        interface_input.delegate = self.receive_audio
        # bulk path: backends that capture all channels in one read
        # (interleaved hardware, the simulator) deliver [C, n] blocks in
        # ONE call — the per-chunk stats vectorize across lanes and the
        # Python call overhead is paid once per block instead of per lane
        interface_input.block_delegate = self.receive_audio_block
        interface_input.gap_delegate = self.receive_capture_gap

    # -- lifecycle (Processor.swift:94-100) ---------------------------------

    def set_up(self) -> None:
        self.output.set_up(self.entries)
        self._stop.clear()
        self._worker = threading.Thread(target=self._process_loop, daemon=True)
        self._worker.start()
        self.interface_input.initialize_audio()

    def tear_down(self) -> None:
        # stop the worker even if the input teardown raises (e.g. tearing
        # down a Processor whose set_up failed before initialize_audio) —
        # otherwise the started worker thread leaks, spinning on its queue
        try:
            self.interface_input.tear_down_audio()
        finally:
            self._stop.set()
            self._work.put(-1)
            if self._worker is not None:
                self._worker.join(timeout=10)
                self._worker = None
            self.output.tear_down()

    # -- capture-thread path (Processor.swift:102-149) ----------------------

    def receive_audio(self, interface, channel: int, data: np.ndarray) -> None:
        if channel >= len(self._channels):
            return
        index = self._channels[channel]
        if index < 0:
            return
        lane = self._lanes[index]

        # mean-square level stat (Processor.swift:111-113)
        data = np.asarray(data, np.float32)
        lane.stat_input.write_value(float(np.mean(data * data)))
        lane.last_audio_ns = _time_ns()

        if lane.resampler is not None:
            data, lane.resampler = linear_resample_chunk_exact(data, lane.resampler)

        if not lane.ring.produce(data):
            # overflow is a hard error in the reference
            # (CircularShortTimeFourierTransform.swift:199); count and
            # drop — and record WHERE in the stream the hole sits
            # (produced_samples so far), so the worker can splice a gap
            # into the detector/bank at the true position instead of
            # silently gluing post-gap audio onto pre-gap audio
            lane.overflows += 1
            lane.dropped_samples += len(data)
            lane.gap_events.append((lane.produced_samples, len(data)))
            return
        lane.produced_samples += len(data)

        self._work.put(index)

    def receive_audio_block(self, interface, block: np.ndarray) -> None:
        """Bulk capture delivery: one ``[channels, n]`` block per device
        read (same capture thread and bookkeeping as
        :meth:`receive_audio`, which this is semantically C calls of).
        The per-chunk level stats vectorize into one einsum across all
        lanes and the Python call overhead is paid once per block — at
        high lane counts the capture fan-out was the second wall after
        the wire (r5 live campaign: 0.26%/lane of a core, 89% at 320
        lanes)."""
        block = np.asarray(block, np.float32)
        n_ch = block.shape[0]
        n = block.shape[1]
        # mean-square level per lane in one pass (no temp per lane)
        ms = np.einsum("ij,ij->i", block, block) / max(n, 1)
        now = _time_ns()
        channels = self._channels
        lanes = self._lanes
        put = self._work.put
        writer = self._block_writer
        if writer is not None and n_ch == len(channels):
            # hot path: ONE native produce call copies every row into its
            # lane's ring; only the bookkeeping loop stays in Python
            ok = writer.produce(block)
            for ch in range(n_ch):
                lane = lanes[channels[ch]]
                lane.stat_input.write_value(float(ms[ch]))
                lane.last_audio_ns = now
                if ok[ch]:
                    lane.produced_samples += n
                    put(channels[ch])
                else:
                    lane.overflows += 1
                    lane.dropped_samples += n
                    lane.gap_events.append((lane.produced_samples, n))
            return
        for ch in range(min(n_ch, len(channels))):
            index = channels[ch]
            if index < 0:
                continue
            lane = lanes[index]
            lane.stat_input.write_value(float(ms[ch]))
            lane.last_audio_ns = now
            data = block[ch]
            if lane.resampler is not None:
                data, lane.resampler = linear_resample_chunk_exact(
                    data, lane.resampler
                )
            if not lane.ring.produce(data):
                lane.overflows += 1
                lane.dropped_samples += len(data)
                lane.gap_events.append((lane.produced_samples, len(data)))
                continue
            lane.produced_samples += len(data)
            put(index)

    def receive_capture_gap(self, interface, lost_frames: int) -> None:
        """The capture DEVICE lost audio (an ALSA xrun): splice a gap of
        the equivalent lane-rate length into every lane at its current
        stream position, so detection timestamps stay sample-accurate
        across the hole. Called from the capture thread (same thread as
        :meth:`receive_audio`, so the gap-event bookkeeping stays
        single-writer)."""
        if lost_frames <= 0:
            return
        for lane in self._lanes:
            e = lane.entry
            if lane.resampler is not None:
                rate = e.config.sampling_rate
                lost = int(round(lost_frames * rate / e.resample_from))
                # the resampler's (last sample, offset) carry refers to
                # pre-gap audio; continuity broke, start fresh
                lane.resampler = linear_resample_init(e.resample_from, rate)
            else:
                lost = int(lost_frames)
            if lost <= 0:
                continue
            lane.capture_gaps += 1
            lane.capture_lost_samples += lost
            lane.gap_events.append((lane.produced_samples, lost))

    # -- worker (the serial "ProcessorQueue", Processor.swift:128-148) ------

    def _process_loop(self) -> None:
        while not self._stop.is_set():
            try:
                index = self._work.get(timeout=0.1)
            except queue.Empty:
                continue
            # batched mode: coalesce every already-queued work item into ONE
            # bank drain, remembering WHICH lanes' capture chunks this round
            # covers — prepare_output(seen=False) fires only for those, so
            # the Arduino 20-drain TTL hold decays once per capture chunk
            # per lane exactly like per-lane mode (Processor.swift:233
            # counts capture rounds), no matter how the worker and the
            # capture fan-out interleave
            extra = 0
            indices = [] if index < 0 else [index]
            if self._banks:
                if self._drain_interval > 0:
                    # hold the batching window open: keep absorbing queued
                    # work until the interval since the last drain elapses
                    # (stop/tear_down breaks out immediately via the -1
                    # sentinel + stop flag)
                    import time as _t

                    deadline = self._last_drain + self._drain_interval
                    while not self._stop.is_set():
                        wait = deadline - _t.monotonic()
                        if wait <= 0:
                            break
                        try:
                            j = self._work.get(timeout=wait)
                        except queue.Empty:
                            break
                        extra += 1
                        if j >= 0:
                            indices.append(j)
                while True:
                    try:
                        j = self._work.get_nowait()
                        extra += 1
                        if j >= 0:
                            indices.append(j)
                    except queue.Empty:
                        break
            try:
                if not indices:
                    continue
                try:
                    if self._banks:
                        if self._drain_interval > 0:
                            import time as _t

                            self._last_drain = _t.monotonic()
                        self._drain_all(set(indices))
                    else:
                        self._drain_lane(index, self._lanes[index])
                except Exception as e:
                    # a transient device/compile error on one drain must not
                    # kill the sole worker thread (capture would keep filling
                    # rings while detection silently stops forever); count,
                    # log, and keep serving the queue
                    self.drain_errors += 1
                    if self.drain_errors <= 5:
                        import sys

                        print(
                            f"processor: drain error on lane {index}: "
                            f"{type(e).__name__}: {e}",
                            file=sys.stderr,
                        )
            finally:
                self._work.task_done()
                for _ in range(extra):
                    self._work.task_done()

    def _feed_with_gaps(self, lane: _Lane, samples, append_fn, gap_fn) -> None:
        """Feed consumed ring samples to the sink, splicing each capture
        overflow gap in at its TRUE in-stream position. Each gap event
        carries the lane's produced-sample count at drop time; comparing
        it against the worker's cumulative appended count locates the
        hole exactly, even when pre- and post-gap samples sit in the
        ring together."""
        base = lane.appended_samples
        n = len(samples)
        pos = 0
        while lane.gap_acked < len(lane.gap_events):
            marker, dropped = lane.gap_events[lane.gap_acked]
            cut = marker - base
            if cut > n:
                break  # the gap lies beyond the samples consumed so far
            cut = max(cut, pos)
            if cut > pos:
                append_fn(samples[pos:cut])
            pos = cut
            gap_fn(dropped)
            lane.gap_acked += 1
        if pos < n:
            append_fn(samples[pos:] if pos else samples)
        lane.appended_samples = base + n
        if lane.gap_acked:
            # drop the acked prefix (appends only ever extend the tail,
            # so trimming what we have acked is race-free under the GIL)
            del lane.gap_events[: lane.gap_acked]
            lane.gap_acked = 0

    def _log_events(self, lane: _Lane, indices, outs) -> None:
        """Emit ``event_log`` rows for this drain's detections (worker
        thread; sink failures are counted like output-backend errors,
        never fatal). Detection criterion = outputs[0] >= thresholds[0],
        the LIVE rule (Processor.swift:27-31) — the offline CLI's
        any-output rule and debounce belong to TrackDetector."""
        cfg = lane.entry.config
        thr = np.float32(cfg.thresholds[0])
        rate = cfg.sampling_rate
        for k in np.flatnonzero(outs[:, 0] >= thr):
            try:
                self.event_log(
                    lane.entry.input_channel,
                    int(indices[k]),
                    float(indices[k] / rate),
                    np.asarray(outs[k], np.float32),
                )
            except Exception as e:
                self._report_output_error(lane.entry.input_channel, e)
                return

    def _report_output_error(self, index, e) -> None:
        # output backend errors are counted and logged, not fatal
        # (Processor.swift:272-276 logs and continues) — a silently
        # swallowed exception would stop TTL output with zero diagnostics
        self.output_errors += 1
        if self.output_errors <= 5:
            import sys

            print(
                f"processor: output backend error on lane {index}: "
                f"{type(e).__name__}: {e}",
                file=sys.stderr,
            )

    def _drain_lane(self, index: int, lane: _Lane) -> None:
        # per-drain latency stats (the reference instruments the same
        # boundary in its simulator, ViewControllerSimulator.swift:291-318)
        t_start = _time_ns()

        samples = lane.ring.peek()
        if len(samples):
            lane.ring.consume(len(samples))

        det = lane.detector
        spec = det.spec
        out_parts = []

        def feed(chunk):
            lane.segment_fed += len(chunk)
            det.append_audio_data(chunk)

        def flush():
            # drain + stamp: output k of this segment ends at stream
            # sample segment_start + first_output_sample + k*hop
            # (TrackDetector.swift:38-42,67-68 accounting)
            part = det.drain()
            if len(part):
                out_parts.append(part)
                if self.event_log is not None:
                    k0 = lane.evals_done
                    idx = (
                        lane.segment_start
                        + spec.first_output_sample
                        + np.arange(k0, k0 + len(part), dtype=np.int64)
                        * spec.hop
                    )
                    self._log_events(lane, idx, part)
                lane.evals_done += len(part)

        def on_gap(n_lost):
            # flush evaluable pre-gap hops, then re-warm past the hole;
            # the stream clock advances over the fed segment AND the gap
            flush()
            det.note_gap(n_lost)
            lane.segment_start += lane.segment_fed + n_lost
            lane.segment_fed = 0
            lane.evals_done = 0

        self._feed_with_gaps(lane, samples, feed, on_gap)
        flush()
        outs = (
            np.concatenate(out_parts, axis=0)
            if out_parts
            else np.zeros((0, spec.net.outputs), np.float32)
        )
        Time.save_with_name(
            "process" if len(outs) else "skip", _time_ns() - t_start
        )
        seen = False
        if len(outs):
            lane.stat_output.write_value(float(np.max(outs[:, 0])))
            thr = np.float32(lane.detector.spec.thresholds[0])
            n_hits = int(np.sum(outs[:, 0] >= thr))
            if n_hits:
                seen = True
                lane.detections += n_hits
        try:
            self.output.prepare_output(index, lane.entry, seen)
        except Exception as e:
            self._report_output_error(index, e)

    def _drain_all(self, drained: Optional[set] = None) -> None:
        """Batched-drain mode: move every lane's ring into its geometry
        group's bank and evaluate each group's new hops in one batched
        device call per group. ``drained`` is the set of lane indices
        whose capture chunks this round covers (default: all lanes) —
        quiet-drain TTL decay (prepare_output with seen=False) fires only
        for those, keeping the Arduino hold-counter cadence at one step
        per capture chunk like per-lane mode."""
        if drained is None:
            drained = set(range(len(self._lanes)))
        t_start = _time_ns()
        any_outs = False
        seen_flags = [False] * len(self._lanes)
        for bank, idxs in self._banks:
            # per-bank error isolation: a transient device failure in one
            # group must not abort the round AFTER earlier groups counted
            # detections (the prepare_output loop below must always run,
            # or counted detections would fire no TTL)
            try:
                for j, i in enumerate(idxs):
                    lane = self._lanes[i]
                    samples = lane.ring.peek()
                    if len(samples):
                        lane.ring.consume(len(samples))

                    def _append(chunk, j=j, lane=lane, bank=bank):
                        if not bank.append_audio_data(j, chunk):
                            # the bank's max_buffer cap dropped the chunk:
                            # surface it on the lane like a ring overflow,
                            # so audio loss stays visible to monitoring
                            # (worker-thread-only counters — see _Lane)
                            lane.bank_overflows += 1
                            lane.bank_dropped_samples += len(chunk)

                    # splice ring-overflow gaps in at their true stream
                    # positions — the bank closes the segment and advances
                    # its stream clock (note_gap), so post-gap outputs
                    # keep sample-accurate indices
                    self._feed_with_gaps(
                        lane,
                        samples,
                        _append,
                        lambda n_lost, j=j, bank=bank: bank.note_gap(j, n_lost),
                    )
                outs = bank.drain()  # [len(idxs), n_max, outputs] padded
                counts = bank.last_counts
            except Exception as e:
                self.drain_errors += 1
                if self.drain_errors <= 5:
                    import sys

                    print(
                        f"processor: bank drain error on lanes {idxs}: "
                        f"{type(e).__name__}: {e}",
                        file=sys.stderr,
                    )
                continue
            if outs.shape[1]:
                any_outs = True
            for j, i in enumerate(idxs):
                lane = self._lanes[i]
                # lanes progress independently: only this lane's valid
                # prefix counts (rows beyond counts[j] are padding)
                o = outs[j, : counts[j]]
                if o.shape[0]:
                    lane.stat_output.write_value(float(np.max(o[:, 0])))
                    # float32 comparison, exactly like the per-lane drain —
                    # the two modes must agree at threshold boundaries
                    thr = np.float32(bank.thresholds[j])
                    n_hits = int(np.sum(o[:, 0] >= thr))
                    if n_hits:
                        seen_flags[i] = True
                        lane.detections += n_hits
                    if self.event_log is not None:
                        # the bank's indices are already sample-accurate
                        # across gaps — same clock as the per-lane mode
                        self._log_events(
                            lane, bank.last_sample_indices[j], o
                        )
        Time.save_with_name(
            "process" if any_outs else "skip", _time_ns() - t_start
        )
        for i, lane in enumerate(self._lanes):
            # a detection always fires; quiet decay only for lanes whose
            # capture chunk this round consumed — the Arduino hold counter
            # decrements once per capture chunk (Processor.swift:147,
            # 277-293), not once per worker wake-up
            if not (seen_flags[i] or i in drained):
                continue
            try:
                self.output.prepare_output(i, lane.entry, seen_flags[i])
            except Exception as e:
                self._report_output_error(i, e)

    def warm_up(self, buckets=None) -> int:
        """Eagerly compile every drain shape this processor can hit (the
        bank's batched buckets, or each lane's Detector buckets). Call
        BEFORE set_up(): a cold drain shape compiles first, which would
        otherwise stall the live worker mid-stream (and outlive drain_pending's timeout). Returns the
        number of shapes compiled."""
        if self._banks:
            # None lets each bank warm its own pinned ladder
            buckets = tuple(buckets) if buckets is not None else None
            return sum(b.warm_up(buckets=buckets) for b, _ in self._banks)
        from syllable_detector_tpu.models.detector import _FRAME_BUCKETS

        buckets = tuple(buckets) if buckets is not None else _FRAME_BUCKETS
        return sum(
            lane.detector.warm_up(buckets=buckets) for lane in self._lanes
        )

    def drain_pending(self, timeout: float = 10.0) -> None:
        """Block until all queued work has been PROCESSED (not merely
        dequeued) — queue.join with a timeout, so a caller reading
        lane.detections afterwards sees the final chunk's results."""
        import time as _t

        deadline = _t.monotonic() + timeout
        with self._work.all_tasks_done:
            while self._work.unfinished_tasks and _t.monotonic() < deadline:
                self._work.all_tasks_done.wait(timeout=0.05)

    # -- stats for UIs (Processor.swift:158-184) ----------------------------

    def get_input_for_channel(self, channel: int) -> Optional[float]:
        index = self._index_for(channel)
        if index is None:
            return None
        v = self._lanes[index].stat_input.read_stat_and_reset()
        return math.sqrt(v) if v is not None else None

    def get_output_for_channel(self, channel: int) -> Optional[float]:
        index = self._index_for(channel)
        if index is None:
            return None
        return self._lanes[index].stat_output.read_stat_and_reset()

    def _index_for(self, channel: int) -> Optional[int]:
        if channel >= len(self._channels):
            return None
        i = self._channels[channel]
        return i if i >= 0 else None

    def lane_detections(self) -> list[int]:
        """Per-lane detection counts (lane order == ``entries`` order)."""
        return [lane.detections for lane in self._lanes]

    def lane_stats(self) -> list[dict]:
        """Per-lane counters for UIs: detections / overflows / dropped
        samples / last-audio age.

        ``last_audio_age_s`` is the seconds since the lane's capture
        callback last delivered audio (None before the first chunk) — a
        dead or unplugged mic shows as a growing age at a glance, where
        the reference's GUI shows per-channel RMS going quiet
        (ViewControllerProcessor.swift:278-284).
        """
        now = _time_ns()
        return [
            {
                "input_channel": lane.entry.input_channel,
                "output_channel": lane.entry.output_channel,
                "detections": lane.detections,
                "overflows": lane.overflows + lane.bank_overflows,
                "dropped_samples": (
                    lane.dropped_samples + lane.bank_dropped_samples
                ),
                # device-side losses (xruns) — distinct from host-side
                # ring/bank drops: the device never delivered these
                "capture_gaps": lane.capture_gaps,
                "capture_lost_samples": lane.capture_lost_samples,
                "last_audio_age_s": (
                    (now - lane.last_audio_ns) / 1e9
                    if lane.last_audio_ns is not None
                    else None
                ),
            }
            for lane in self._lanes
        ]
