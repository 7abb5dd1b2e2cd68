"""Process-isolated streaming detection with automatic crash recovery.

An accelerator runtime has a failure mode the reference never faced: a
device error can POISON the whole process — every later device call fails
until the process is replaced. The reference's recovery story is "restart
the app" (SURVEY §5); for a closed-loop experiment that means losing the
session.

:class:`ResilientDetector` keeps the device work in a CHILD process and
supervises it:

  * the child hosts a :class:`~syllable_detector_tpu.models.detector_bank.
    DetectorBank` (1..N lanes, distinct nets supported) and serves
    append/drain/warm_up requests over a pipe;
  * after every successful drain the child returns its post-drain state
    snapshot, which the parent retains;
  * audio appended since the last snapshot is journaled in the parent; if
    the child dies (crash, poisoned runtime, timeout), the parent spawns a
    FRESH process, restores the snapshot, replays the journal, and retries
    — the output stream continues exactly where it stopped (same
    exactly-once hop accounting as an uninterrupted detector).

The child is created with the ``spawn`` start method so it gets a fresh
XLA runtime — the entire point of the isolation. The child owns the card
and the supervisor never starts a JAX backend: a JAX process reserves most
of a GPU's memory, so a second one on the card would fail for want of it.
For the same reason a crashed child is reaped (terminated, then killed)
before its replacement starts. Spawn re-imports the
parent's ``__main__``, so construct ResilientDetector from an importable
script or module (standard multiprocessing caveat: a ``<stdin>``/REPL
``__main__`` cannot be re-imported by the child).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
from typing import Optional

import numpy as np

__all__ = ["ResilientDetector", "DetectorChildError", "DetectorChildCrash"]


class DetectorChildError(RuntimeError):
    """A SEMANTIC error from the child (bad argument, bad state): the
    request is wrong, not the process — deterministic, so a respawn would
    just replay the same failure (each one a cold compile). The supervisor re-raises these immediately without a
    restart; the child stays alive and keeps serving."""


class DetectorChildCrash(RuntimeError):
    """A crash-class child failure (unexpected exception, poisoned
    runtime, dead pipe): the process is suspect — the supervisor restarts
    it with snapshot + journal replay."""


# request errors of these types are semantic (caller mistakes), not
# process poisoning: the child reports them and keeps serving
_SEMANTIC_ERRORS = (ValueError, TypeError, KeyError, IndexError)


def _child_main(conn, net_texts, platform, max_buffer_seconds=30.0):
    """Child process: build the bank, serve requests until EOF/stop."""
    try:
        if platform:
            import jax

            jax.config.update("jax_platforms", platform)
        from syllable_detector_tpu.config.model_format import loads_config
        from syllable_detector_tpu.models.detector_bank import DetectorBank

        cfgs = [loads_config(t) for t in net_texts]
        bank = DetectorBank(cfgs, max_buffer_seconds=max_buffer_seconds)
        conn.send(("ready", None))
        while True:
            try:
                msg = conn.recv()
            except EOFError:
                return
            op = msg[0]
            if op == "stop":
                conn.send(("ok", None))
                return
            if op == "crash":  # test hook: simulate a poisoned process
                os._exit(17)
            try:
                if op == "append":
                    _, lane, samples = msg
                    bank.append_audio_data(lane, samples)
                    conn.send(("ok", None))
                elif op == "note_gap":
                    _, lane, n = msg
                    bank.note_gap(lane, n)
                    conn.send(("ok", None))
                elif op == "drain":
                    outs = bank.drain()
                    conn.send(
                        (
                            "ok",
                            (
                                outs,
                                bank.last_counts,
                                list(bank.last_sample_indices),
                                bank.get_state(),
                            ),
                        )
                    )
                elif op == "warm_up":
                    n = bank.warm_up(buckets=msg[1])
                    conn.send(("ok", (n, bank.get_state())))
                elif op == "set_state":
                    bank.set_state(msg[1])
                    conn.send(("ok", None))
                else:
                    conn.send(("error", f"unknown op {op!r}"))
            except _SEMANTIC_ERRORS as e:
                # a bad request is the CALLER's bug, not process poisoning:
                # report and keep serving (the parent raises without a
                # respawn — deterministic errors would burn max_restarts)
                conn.send(("error", f"{type(e).__name__}: {e}"))
    except Exception as e:  # construction/serve crashes: process is suspect
        try:
            conn.send(("fatal", f"{type(e).__name__}: {e}"))
        except Exception:
            pass
        os._exit(1)


class ResilientDetector:
    """Supervised multi-lane streaming detector (crash-isolated device work).

    ``configs``: one or more SyllableDetectorConfig (distinct nets per lane
    like DetectorBank). ``platform=None`` pins the child to the parent's
    configured jax platform (tests run CPU; live sessions spawn GPU
    children). ``timeout`` bounds each request; a drain on a cold shape
    compiles first, so either call :meth:`warm_up` first or keep the
    default generous.
    """

    def __init__(
        self,
        configs,
        max_restarts: int = 3,
        timeout: float = 900.0,
        platform: Optional[str] = None,
        max_buffer_seconds: float = 30.0,
    ):
        from syllable_detector_tpu.config.model_format import dumps_config

        if not isinstance(configs, (list, tuple)):
            configs = [configs]
        self._net_texts = [dumps_config(c) for c in configs]
        self.n_lanes = len(configs)
        self.max_restarts = max_restarts
        self.timeout = timeout
        # the parent MIRRORS the child bank's max_buffer cap: appends the
        # bank would drop (overflow) are journaled as compact gap markers
        # instead of full chunks, so the replay journal is bounded by the
        # bank's own buffering cap per lane — a caller that appends for a
        # long stretch without draining no longer doubles memory
        self.max_buffer_seconds = max_buffer_seconds
        self._max_buffer_samples = int(
            max_buffer_seconds * configs[0].sampling_rate
        )
        # per-lane mirror of the child bank's buffered sample count
        # (snapshot buffering + accepted journal entries) — exact between
        # drains, since the bank only trims inside drain/warm_up and both
        # refresh the snapshot
        self._buffered = [0] * self.n_lanes
        if platform is None:
            # inherit an EXPLICITLY configured platform (tests force CPU
            # via JAX_PLATFORMS) — read from the config, never via
            # jax.default_backend(): that would INITIALIZE a backend in the
            # parent, which on a GPU reserves most of the card's memory
            # and starves the child.
            # With no explicit config, the CHILD picks its own default and
            # owns the accelerator; the supervisor stays device-free.
            import sys as _sys

            jax_mod = _sys.modules.get("jax")
            if jax_mod is not None:
                platform = jax_mod.config.jax_platforms or None
        self._platform = platform
        self.restarts = 0
        self.last_counts = np.zeros(self.n_lanes, np.int64)
        self.last_sample_indices = [
            np.zeros(0, np.int64) for _ in range(self.n_lanes)
        ]
        self._snapshot = None  # last known-good post-drain state
        # appends since the snapshot: ("append", lane, samples) for chunks
        # the bank accepts, ("gap", lane, n) compact markers for chunks
        # the bank's cap drops (replayed as note_gap — data-free)
        self._journal: list[tuple] = []
        # per-lane index of the lane's trailing gap marker in _journal
        # (None once an append for the lane lands after it) — O(1)
        # coalescing of consecutive overflow drops
        self._gap_idx: list = [None] * self.n_lanes
        # trailing partial interleaved frame (parent-side de-interleave,
        # append_interleaved_audio_data) — crash replay never sees it
        self._interleave_rem = np.zeros(0, np.float32)
        self._ctx = mp.get_context("spawn")
        self._proc = None
        self._conn = None
        self._start_child()

    # -- supervision --------------------------------------------------------

    def _start_child(self) -> None:
        parent_conn, child_conn = self._ctx.Pipe()
        self._proc = self._ctx.Process(
            target=_child_main,
            args=(
                child_conn,
                self._net_texts,
                self._platform,
                self.max_buffer_seconds,
            ),
            daemon=True,
        )
        self._proc.start()
        child_conn.close()
        self._conn = parent_conn
        try:
            status, payload = self._recv()
            if status != "ready":
                raise RuntimeError(f"detector child failed to start: {payload}")
            if self._snapshot is not None:
                self._request(("set_state", self._snapshot))
            for entry in self._journal:
                if entry[0] == "gap":
                    self._request(("note_gap", entry[1], entry[2]))
                else:
                    self._request(("append", entry[1], entry[2]))
        except DetectorChildError:
            raise  # semantic replay failure: child is alive and sane
        except Exception:
            # a hung/failed handshake must not LEAK the child: when this
            # escapes __init__ (e.g. a TimeoutError while the device backend
            # hangs initializing) no instance exists, close() can never
            # run, and a daemon child would keep the exclusive device
            # claim for the rest of the parent's life
            self._kill_child()
            raise

    def _recv(self):
        if not self._conn.poll(self.timeout):
            raise TimeoutError(f"detector child unresponsive for {self.timeout}s")
        return self._conn.recv()

    def _request(self, msg):
        self._conn.send(msg)
        status, payload = self._recv()
        if status == "fatal":
            raise DetectorChildCrash(f"detector child failed: {payload}")
        if status == "error":
            raise DetectorChildError(payload)
        return payload

    def _supervised(self, msg, covered_by_replay: bool = False):
        """Send a request, restarting the child (snapshot + journal replay)
        on CRASH-CLASS failures only — dead pipe, timeout, unexpected child
        exception — up to max_restarts times. Semantic child errors
        (:class:`DetectorChildError`, e.g. a bad set_state) re-raise
        immediately: they are deterministic, so each respawn would replay
        the same failure at full cold-compile cost.

        ``covered_by_replay``: the message's effect is already in the
        journal, so after a restart (whose replay applied it) the message
        must NOT be re-sent — re-sending would apply it twice and break
        the exactly-once hop accounting.
        """
        attempts = 0
        while True:
            try:
                return self._request(msg)
            except DetectorChildError:
                raise
            except (EOFError, OSError, TimeoutError, DetectorChildCrash):
                self._kill_child()
                self.restarts += 1
                attempts += 1
                if attempts > self.max_restarts:
                    raise
                # the recovery itself (spawn, ready handshake, set_state,
                # journal replay) can crash too — keep IT supervised, or
                # one unlucky replay failure escapes with a dead child
                # pinned on self._proc/_conn and every later call fails
                while True:
                    try:
                        self._start_child()
                        break
                    except DetectorChildError:
                        # semantic failure replaying state: deterministic,
                        # a respawn would replay it at full cold-compile
                        # cost — surface immediately
                        raise
                    except Exception:
                        self._kill_child()
                        self.restarts += 1
                        attempts += 1
                        if attempts > self.max_restarts:
                            raise
                if covered_by_replay:
                    return None

    def _kill_child(self) -> None:
        try:
            self._conn.close()
        except Exception:
            pass
        if self._proc is not None:
            self._proc.terminate()
            self._proc.join(timeout=5)
            if self._proc.is_alive():  # stuck in a driver call: SIGKILL
                self._proc.kill()
                self._proc.join()
            self._proc = None

    # -- detector API --------------------------------------------------------

    def append_audio_data(self, samples: np.ndarray, lane: int = 0) -> None:
        # own the data: np.asarray on an already-float32 buffer is a
        # VIEW — a capture loop that reuses one persistent buffer would
        # retroactively rewrite every journal entry to the last block's
        # contents, silently corrupting crash-recovery replay (the pipe
        # send pickles a snapshot, so live operation LOOKS correct). A
        # journaled slice would also pin its whole base recording alive.
        samples = np.array(samples, np.float32, copy=True).reshape(-1)
        n = len(samples)
        if self._buffered[lane] + n > self._max_buffer_samples:
            # the child bank would drop this chunk at its cap — same
            # journaled gap as an externally reported one
            self.note_gap(lane, n)
            return
        # journal FIRST: if the child dies handling this append, the
        # restart's replay applies it — and covered_by_replay then skips
        # the resend (sending again would double-apply the chunk)
        self._gap_idx[lane] = None
        self._journal.append(("append", lane, samples))
        self._buffered[lane] += n
        self._supervised(("append", lane, samples), covered_by_replay=True)

    def note_gap(self, lane: int, n: int) -> None:
        """Register ``n`` samples of the lane's stream as LOST — an
        internal buffer-cap drop, or an externally observed capture gap
        (a device xrun). Journaled as a compact data-free marker so
        replay reproduces the bank's gap accounting without retaining
        unbounded audio. Consecutive gaps on a lane COALESCE into one
        marker (order only matters within a lane): a stalled drain loop
        otherwise grows the journal by one tuple per dropped chunk
        forever. Replay applies one note_gap with the summed n —
        stream-clock and dropped-sample accounting are identical; only
        the overflow EVENT count merges (live counts stay per-event)."""
        gi = self._gap_idx[lane]
        if gi is not None:
            _, _, prev = self._journal[gi]
            self._journal[gi] = ("gap", lane, prev + n)
        else:
            self._gap_idx[lane] = len(self._journal)
            self._journal.append(("gap", lane, n))
        self._supervised(("note_gap", lane, n), covered_by_replay=True)

    def append_interleaved_audio_data(self, samples: np.ndarray) -> None:
        """Fan an interleaved ``n_lanes``-channel capture buffer out to
        the lanes (frame-major), carrying a trailing partial frame into
        the next call — DetectorBank.append_interleaved_audio_data
        semantics. The de-interleave happens parent-side, so the journal
        and crash replay see plain per-lane appends."""
        from syllable_detector_tpu.models.detector import deinterleave_frames

        frames, self._interleave_rem = deinterleave_frames(
            samples, self._interleave_rem, self.n_lanes
        )
        for lane in range(self.n_lanes):
            self.append_audio_data(
                np.ascontiguousarray(frames[:, lane]), lane=lane
            )

    def note_interleaved_gap(self, n: int) -> None:
        """A capture gap on the INTERLEAVED stream feeding all lanes
        (``n`` interleaved samples lost): every lane loses
        ``n // n_lanes`` samples, the pending partial frame is discarded
        (pre-gap audio), and the lanes whose carried sample it held get
        it counted into their gap — DetectorBank.note_interleaved_gap
        semantics."""
        per_lane = n // self.n_lanes
        rem_len = len(self._interleave_rem)
        self._interleave_rem = np.zeros(0, np.float32)
        for lane in range(self.n_lanes):
            self.note_gap(lane, per_lane + (1 if lane < rem_len else 0))

    def drain(self) -> np.ndarray:
        outs, counts, sample_indices, state = self._supervised(("drain",))
        self.last_counts = counts
        self.last_sample_indices = sample_indices
        self._sync_snapshot(state)
        return outs

    def _sync_snapshot(self, state) -> None:
        self._snapshot = state
        self._journal.clear()
        self._gap_idx = [None] * self.n_lanes
        self._buffered = [
            sum(len(d) for _, d, _ in segs) for segs in state["segments"]
        ]

    def warm_up(self, buckets=None) -> int:
        from syllable_detector_tpu.models.detector import _FRAME_BUCKETS

        buckets = tuple(buckets) if buckets is not None else _FRAME_BUCKETS
        n, state = self._supervised(("warm_up", buckets))
        # the returned state already contains any journaled appends; keep
        # snapshot and journal consistent (journal entries kept alongside
        # a snapshot that includes them would double-apply after a crash)
        self._sync_snapshot(state)
        return n

    def crash_for_test(self) -> None:
        """Make the child die abruptly (simulates a poisoned runtime)."""
        try:
            self._conn.send(("crash",))
        except Exception:
            pass
        if self._proc is not None:
            self._proc.join(timeout=10)

    def close(self) -> None:
        try:
            if self._proc is not None and self._proc.is_alive():
                self._conn.send(("stop",))
                self._conn.poll(5)
        except Exception:
            pass
        self._kill_child()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
