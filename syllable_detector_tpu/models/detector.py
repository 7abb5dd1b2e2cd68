"""Detection pipeline core — the batched re-design of Common/SyllableDetector.swift.

The reference drives a streaming vDSP FFT and a feature ring buffer one hop at
a time (SyllableDetector.swift:129-217). Here the same math is expressed three
ways, all sharing one set of pure ops:

  * :func:`offline_outputs` — whole-signal batched evaluation: hop-strided
    frame gather -> band-limited windowed DFT (two GEMMs) -> magnitude ->
    sliding feature stack -> scaling -> MLP. One fused XLA computation; this
    is the throughput path and the fidelity oracle.
  * :func:`streaming_step` — a fixed-shape step over chunks of ``H`` hops
    with a (residual samples, frame history) carry, suitable for
    ``lax.scan`` and for low-latency on-device streaming. Equivalent to the
    offline path once primed (chunk-size invariance is tested).
  * :class:`Detector` — host-side object with the reference's
    appendAudioData / processNewValue semantics for arbitrary chunk sizes
    (SyllableDetector.swift:129-231), batching drains into bucketed
    fixed-shape device calls to avoid retracing.

Validation mirrors SyllableDetector.init: net inputs must equal
bins x timeRange and threshold count must equal net outputs
(SyllableDetector.swift:52-60). The detector always uses the *hamming*
window (SyllableDetector.swift:42-43) and extractPower = |X| magnitudes
(SyllableDetector.swift:136; see ops/stft.py for the naming swap).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from syllable_detector_tpu.config.model_format import SyllableDetectorConfig
from syllable_detector_tpu.models.neural_net import NetSpec, apply_net, net_from_config
from syllable_detector_tpu.ops.scaling import apply_scaling
from syllable_detector_tpu.ops.stft import (
    frame_signal,
    frequency_index_range,
    hop_length,
    normalize_overlap,
    num_frames,
    spectral_frames,
    stack_features,
)

__all__ = [
    "DetectorSpec",
    "detector_spec_from_config",
    "detect_features",
    "offline_outputs",
    "streaming_init",
    "streaming_step",
    "Detector",
]

WINDOW = "hamming"  # forced by the detector (SyllableDetector.swift:42-43)


@dataclass(frozen=True)
class DetectorSpec:
    """Hashable static description of one detector pipeline."""

    sampling_rate: float
    fourier_length: int
    window_length: int
    window_overlap: int  # raw; negative = gap
    time_range: int
    scaling: str
    bins: tuple[int, int]  # [lo, hi) band of DFT bins
    thresholds: tuple[float, ...]
    net: NetSpec

    @property
    def n_bins(self) -> int:
        return self.bins[1] - self.bins[0]

    @property
    def hop(self) -> int:
        return hop_length(self.window_length, self.window_overlap)

    @property
    def history(self) -> int:
        """Frames of history carried between evals (timeRange - 1)."""
        return self.time_range - 1

    @property
    def residual(self) -> int:
        """Samples left in the ring after each consumed hop."""
        gap, overlap = normalize_overlap(self.window_overlap)
        return overlap

    @property
    def first_output_sample(self) -> int:
        from syllable_detector_tpu.config.model_format import (
            first_output_sample,
        )

        return first_output_sample(
            self.window_length, self.window_overlap, self.time_range
        )


def detector_spec_from_config(cfg: SyllableDetectorConfig) -> tuple[DetectorSpec, dict]:
    """Build (static spec, net params) with the reference's init-time checks."""
    bins = frequency_index_range(
        cfg.fourier_length, cfg.freq_range[0], cfg.freq_range[1], cfg.sampling_rate
    )
    if bins is None:
        raise ValueError("The frequency range is invalid.")
    net_spec, params = net_from_config(cfg)
    expected_inputs = (bins[1] - bins[0]) * cfg.time_range
    if expected_inputs != net_spec.inputs:
        raise ValueError(
            f"The neural network has {net_spec.inputs} inputs, but the "
            f"configuration settings suggest there should be {expected_inputs}."
        )
    if len(cfg.thresholds) != net_spec.outputs:
        raise ValueError(
            f"The neural network has {net_spec.outputs} outputs, but the "
            f"configuration settings suggest there should be "
            f"{len(cfg.thresholds)}."
        )
    spec = DetectorSpec(
        sampling_rate=float(cfg.sampling_rate),
        fourier_length=cfg.fourier_length,
        window_length=cfg.window_length,
        window_overlap=cfg.window_overlap,
        time_range=cfg.time_range,
        scaling=cfg.scaling,
        bins=bins,
        thresholds=tuple(float(t) for t in cfg.thresholds),
        net=net_spec,
    )
    return spec, params


def fusable(spec: DetectorSpec) -> bool:
    """Whether the net's input chain folds into its first layer: an
    optional leading l2normalize, then only affines (mapminmax/mapstd),
    affine output maps, and known transfers. The tensor-parallel path
    relies on this algebra."""
    for name in spec.net.input_processing:
        if name not in ("l2normalize", "mapminmax", "mapstd", "passthrough"):
            return False
    # l2normalize must come first if present (it does in MATLAB exports,
    # convert_to_text.m:118-182) so the affines fold into W1
    names = [n for n in spec.net.input_processing if n != "passthrough"]
    if "l2normalize" in names[1:]:
        return False
    for name in spec.net.output_processing:
        if name not in ("mapminmax", "mapstd", "passthrough"):
            return False
    for t in spec.net.transfers:
        if t not in ("TanSig", "LogSig", "PureLin", "SatLin"):
            return False
    return spec.scaling in ("linear", "log", "db")


def detect_features(spec: DetectorSpec, params: dict, features: jax.Array) -> jax.Array:
    """[..., timeRange*bins] feature vectors -> [..., outputs].

    Applies spectrogram scaling then the net
    (SyllableDetector.swift:183-214).
    """
    return apply_net(spec.net, params, apply_scaling(features, spec.scaling))


@partial(jax.jit, static_argnames=("spec", "method"))
def offline_outputs(
    spec: DetectorSpec, params: dict, x: jax.Array, method: str = "matmul"
) -> jax.Array:
    """Whole-signal detection: [n] samples -> [n_evals, outputs]."""
    n = x.shape[0]
    f = num_frames(n, spec.window_length, spec.window_overlap)
    frames = frame_signal(x, f, spec.window_length, spec.window_overlap)
    band = spectral_frames(
        frames,
        spec.fourier_length,
        window_type=WINDOW,
        bins=spec.bins,
        kind="magnitude",
        method=method,
    )
    feats = stack_features(band, spec.time_range)
    return detect_features(spec, params, feats)


# ---------------------------------------------------------------------------
# fixed-shape streaming (lax.scan-able)
# ---------------------------------------------------------------------------


def streaming_init(spec: DetectorSpec, prefix: jax.Array | None = None) -> dict:
    """Initial carry.

    ``prefix`` must be the stream's first ``spec.residual`` samples (prime the
    overlap window); pass None to start from zeros (outputs for the first
    ``time_range - 1`` frames are then warm-up garbage and the first
    ``residual`` samples are treated as zero).
    """
    r = spec.residual
    res = jnp.zeros((r,), jnp.float32)
    if prefix is not None:
        prefix = jnp.asarray(prefix, jnp.float32)
        if prefix.shape != (r,):
            raise ValueError(
                f"prefix must be the stream's first {r} samples "
                f"(spec.residual), got shape {prefix.shape}"
            )
        res = prefix
    return {
        "residual": res,
        "history": jnp.zeros((spec.history, spec.n_bins), jnp.float32),
    }


@partial(jax.jit, static_argnames=("spec", "method"))
def streaming_step(
    spec: DetectorSpec, params: dict, carry: dict, chunk: jax.Array, method: str = "matmul"
) -> tuple[dict, jax.Array]:
    """One fixed-shape step over a chunk of ``H * hop`` samples.

    Emits exactly H outputs (one per hop). Output h of the global stream's
    frame g is valid once g >= time_range - 1; the caller discards the warm-up
    rows, reproducing the reference's "first decision after
    window + hop*(timeRange-1) samples" accounting (TrackDetector.swift:38-42).
    """
    hop = spec.hop
    h_hops = chunk.shape[0] // hop
    if chunk.shape[0] != h_hops * hop:
        raise ValueError(
            f"chunk length {chunk.shape[0]} must be a multiple of the "
            f"hop ({hop})"
        )
    samples = jnp.concatenate([carry["residual"], chunk])
    frames = frame_signal(samples, h_hops, spec.window_length, spec.window_overlap)
    band = spectral_frames(
        frames,
        spec.fourier_length,
        window_type=WINDOW,
        bins=spec.bins,
        kind="magnitude",
        method=method,
    )
    hist = jnp.concatenate([carry["history"], band])  # [T-1+H, B]
    feats = stack_features(hist, spec.time_range)  # [H, T*B]
    outs = detect_features(spec, params, feats)
    new_carry = {
        "residual": samples[h_hops * hop :],
        "history": hist[h_hops:],
    }
    return new_carry, outs


@partial(jax.jit, static_argnames=("spec", "chunk_hops", "method"))
def streaming_scan(
    spec: DetectorSpec,
    params: dict,
    x: jax.Array,
    chunk_hops: int = 16,
    method: str = "matmul",
) -> jax.Array:
    """Run a whole stream through the fixed-shape streaming step with one
    on-device ``lax.scan`` -> [n_evals, outputs].

    Numerically identical to :func:`offline_outputs` (the first
    ``spec.residual`` samples prime the carry; warm-up rows are dropped);
    exists to keep long streaming sessions entirely device-resident.
    """
    r = spec.residual
    hop = spec.hop
    step_len = chunk_hops * hop
    n = x.shape[0]
    # zero-pad the tail to a whole number of chunks; each eval depends only
    # on its own sample window, so the padded evals are sliced away below and
    # the kept rows match offline_outputs(x) exactly
    n_chunks = max(0, -(-(n - r) // step_len)) if n > r else 0
    usable = r + n_chunks * step_len
    if usable > n:
        x = jnp.concatenate([x, jnp.zeros(usable - n, x.dtype)])
    carry = streaming_init(spec, prefix=x[:r] if r else None)
    chunks = x[r:usable].reshape(n_chunks, step_len)

    def body(c, chunk):
        c, outs = streaming_step(spec, params, c, chunk, method=method)
        return c, outs

    _, outs = jax.lax.scan(body, carry, chunks)
    outs = outs.reshape(n_chunks * chunk_hops, spec.net.outputs)
    # drop warm-up rows (frames before the feature window fills), and trim to
    # the eval count the offline path produces on the original n samples
    f = num_frames(n, spec.window_length, spec.window_overlap)
    n_evals = max(0, f - spec.time_range + 1)
    return outs[spec.history : spec.history + n_evals]


# ---------------------------------------------------------------------------
# host-side streaming detector (arbitrary chunk sizes, bucketed device calls)
# ---------------------------------------------------------------------------

_FRAME_BUCKETS = (8, 32, 128, 512, 2048, 8192)


@partial(jax.jit, static_argnames=("spec", "f_max", "method"))
def _drain_step(
    spec: DetectorSpec,
    params: dict,
    samples: jax.Array,  # [(f_max-1)*hop + gap + window], zero-padded
    history: jax.Array,  # [T-1, B]
    n_valid: jax.Array,  # scalar int32: frames actually present
    f_max: int,
    method: str = "matmul",
):
    frames = frame_signal(samples, f_max, spec.window_length, spec.window_overlap)
    band = spectral_frames(
        frames,
        spec.fourier_length,
        window_type=WINDOW,
        bins=spec.bins,
        kind="magnitude",
        method=method,
    )
    hist = jnp.concatenate([history, band])  # [T-1+f_max, B]
    feats = stack_features(hist, spec.time_range)  # [f_max, T*B]
    outs = detect_features(spec, params, feats)
    # new history = rows [n_valid, n_valid + T - 1) of hist
    new_hist = jax.lax.dynamic_slice(
        hist, (n_valid, 0), (spec.history, spec.n_bins)
    )
    return outs, new_hist


def deinterleave_frames(
    samples: np.ndarray, rem: np.ndarray, channels: int
) -> tuple[np.ndarray, np.ndarray]:
    """Split a frame-major interleaved capture buffer into whole
    ``[n, channels]`` frames plus the trailing PARTIAL frame (to carry
    into the next call). Shared by :meth:`Detector.append_interleaved_data`
    and ``DetectorBank.append_interleaved_audio_data`` so the carry
    semantics cannot drift between them."""
    flat = np.asarray(samples, np.float32).reshape(-1)
    if len(rem):
        flat = np.concatenate([rem, flat])
    n = len(flat) // channels
    return (
        flat[: n * channels].reshape(n, channels),
        flat[n * channels :].copy(),
    )


class Detector:
    """Host-side streaming detector with the reference's semantics.

    appendAudioData / processNewValue / lastOutputs / lastDetected /
    seenSyllable (SyllableDetector.swift:26-31, 129-231), except drains are
    batched: ``drain()`` returns *all* newly available outputs as an array
    instead of looping one hop per call.
    """

    def __init__(self, cfg: SyllableDetectorConfig, method: str = "matmul"):
        self.config = cfg
        self.spec, params = detector_spec_from_config(cfg)
        self.params = jax.device_put(params)  # no per-drain weight upload
        self.method = method
        self._residual = np.zeros(0, np.float32)
        self._history = jnp.zeros((self.spec.history, self.spec.n_bins), jnp.float32)
        self._frames_seen = 0  # global frame counter (for warm-up discard)
        self.last_outputs = np.zeros(self.spec.net.outputs, np.float32)
        # trailing partial interleaved frame awaiting the next capture
        # chunk (append_interleaved_data)
        self._interleave_rem = np.zeros(0, np.float32)
        self._interleave_channels = None

    @property
    def last_detected(self) -> bool:
        # lastOutputs[0] >= thresholds[0] (SyllableDetector.swift:27-31)
        return bool(float(self.last_outputs[0]) >= self.spec.thresholds[0])

    def append_audio_data(self, samples: np.ndarray) -> None:
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._residual = np.concatenate([self._residual, samples])

    def append_interleaved_data(
        self, samples: np.ndarray, channels: int, channel: int = 0
    ) -> None:
        """Append ONE channel's samples out of an interleaved capture
        buffer (frame-major [s0c0, s0c1, ..., s1c0, ...]) — the
        reference's strided appendInterleavedData
        (CircularShortTimeFourierTransform.swift:203-217); Linux capture
        APIs deliver multi-channel audio interleaved.

        A trailing PARTIAL frame (length not a multiple of ``channels`` —
        a short read or xrun boundary) is retained and prepended to the
        next call with the same ``channels``, so no samples are silently
        dropped; a call with a different ``channels`` discards the stale
        remainder (the framing changed)."""
        if not 0 <= channel < channels:
            raise ValueError(f"channel {channel} out of range 0..{channels - 1}")
        rem = (
            self._interleave_rem
            if self._interleave_channels == channels
            else np.zeros(0, np.float32)
        )
        frames, self._interleave_rem = deinterleave_frames(
            samples, rem, channels
        )
        self._interleave_channels = channels
        self.append_audio_data(np.ascontiguousarray(frames[:, channel]))

    def drain(self) -> np.ndarray:
        """Process all buffered hops; returns [n_new, outputs] (may be empty).

        The first timeRange-1 frames of the stream produce no output, matching
        the reference's "wait until the feature ring holds timeRange frames"
        rule (SyllableDetector.swift:164-178).
        """
        spec = self.spec
        buf = self._residual
        f = num_frames(len(buf), spec.window_length, spec.window_overlap)
        if f == 0:
            return np.zeros((0, spec.net.outputs), np.float32)

        f_max = next((b for b in _FRAME_BUCKETS if b >= f), None)
        if f_max is None:
            # enormous backlog: process in largest-bucket slabs
            outs = []
            while num_frames(
                len(self._residual), spec.window_length, spec.window_overlap
            ) > 0:
                outs.append(self._drain_up_to(_FRAME_BUCKETS[-1]))
            return (
                np.concatenate(outs, axis=0)
                if outs
                else np.zeros((0, spec.net.outputs), np.float32)
            )
        return self._drain_up_to(f_max)

    def _drain_up_to(self, f_max: int) -> np.ndarray:
        spec = self.spec
        buf = self._residual
        f = min(
            num_frames(len(buf), spec.window_length, spec.window_overlap), f_max
        )
        if f == 0:
            return np.zeros((0, spec.net.outputs), np.float32)
        gap, _ = normalize_overlap(spec.window_overlap)
        need = (f_max - 1) * spec.hop + gap + spec.window_length
        take = min(len(buf), need)
        samples = np.zeros(need, np.float32)
        samples[:take] = buf[:take]
        outs, new_hist = _drain_step(
            spec,
            self.params,
            jnp.asarray(samples),
            self._history,
            jnp.int32(f),
            f_max,
            self.method,
        )
        self._history = new_hist
        self._residual = buf[f * spec.hop :]
        outs = np.asarray(outs[:f])
        # discard stream warm-up rows (frames before timeRange-1)
        skip = max(0, spec.history - self._frames_seen)
        self._frames_seen += f
        outs = outs[skip:]
        if len(outs):
            self.last_outputs = outs[-1]
        return outs

    def warm_up(self, buckets: tuple = _FRAME_BUCKETS) -> int:
        """Eagerly compile every drain shape this detector can hit.

        Each distinct frame bucket is one compiled device computation, so
        a live session that first meets a bucket mid-stream stalls for a
        compile. Calling ``warm_up()`` (optionally with a subset of
        ``_FRAME_BUCKETS``) moves every compile to session start; the
        persistent compile cache (utils/compile_cache.py) makes later
        processes fast. Returns the number of shapes compiled. After a
        full warm_up, ``drain()`` never triggers a new trace (tested via
        the jit cache-size contract).
        """
        spec = self.spec
        gap, _ = normalize_overlap(spec.window_overlap)
        n = 0
        for b in buckets:
            need = (b - 1) * spec.hop + gap + spec.window_length
            out, _ = _drain_step(
                spec,
                self.params,
                jnp.zeros(need, jnp.float32),
                jnp.zeros((spec.history, spec.n_bins), jnp.float32),
                jnp.int32(0),
                b,
                self.method,
            )
            jax.block_until_ready(out)
            n += 1
        return n

    def note_gap(self, n: int = 0) -> None:
        """Register a capture discontinuity (``n`` samples lost — an
        upstream ring overflow, or an externally observed gap): windows
        must never straddle missing audio, so the streaming state resets
        and the stream re-warms on the far side exactly like a fresh one
        (the warm-up rule of SyllableDetector.swift:164-178 re-applies).

        Evaluable pre-gap hops still buffered are DISCARDED — call
        :meth:`drain` first to flush them. ``n`` is accepted for API
        symmetry with :meth:`DetectorBank.note_gap`; a plain Detector
        keeps no absolute stream clock, so only the discontinuity itself
        matters here."""
        self._residual = np.zeros(0, np.float32)
        self._history = jnp.zeros(
            (self.spec.history, self.spec.n_bins), jnp.float32
        )
        self._frames_seen = 0
        # a pending partial interleaved frame is pre-gap audio too — keeping
        # it would glue stale samples onto the post-gap stream and shift the
        # de-interleave framing
        self._interleave_rem = np.zeros(0, np.float32)

    def seen_syllable(self) -> bool:
        """Drain and OR detections on output 0
        (SyllableDetector.swift:220-230)."""
        outs = self.drain()
        if not len(outs):
            return False
        return bool(np.any(outs[:, 0] >= np.float32(self.spec.thresholds[0])))

    # -- state checkpoint / resume (beyond the reference, whose only
    # recovery is restarting the app — SURVEY §5 checkpoint/resume) --------

    def get_state(self) -> dict:
        """Snapshot the streaming state (buffered samples, frame history,
        warm-up counter, last outputs) as plain numpy arrays."""
        return {
            "residual": np.asarray(self._residual, np.float32).copy(),
            "history": np.asarray(self._history, np.float32).copy(),
            "frames_seen": int(self._frames_seen),
            "last_outputs": np.asarray(self.last_outputs, np.float32).copy(),
            # pending partial interleaved frame (append_interleaved_data);
            # channels stored as int, 0 = none (npz-friendly, no pickling)
            "interleave_rem": self._interleave_rem.copy(),
            "interleave_channels": int(self._interleave_channels or 0),
        }

    def set_state(self, state: dict) -> None:
        """Restore a snapshot taken by :meth:`get_state` (possibly in a
        different process); continuing the stream afterwards produces
        exactly the outputs an uninterrupted detector would."""
        residual = np.asarray(state["residual"], np.float32)
        history = np.asarray(state["history"], np.float32)
        if history.shape != (self.spec.history, self.spec.n_bins):
            raise ValueError(
                f"state history shape {history.shape} does not match this "
                f"detector ({self.spec.history}, {self.spec.n_bins})"
            )
        self._residual = residual.copy()
        self._history = jnp.asarray(history)
        self._frames_seen = int(state["frames_seen"])
        self.last_outputs = np.asarray(state["last_outputs"], np.float32).copy()
        self._interleave_rem = np.asarray(
            state.get("interleave_rem", np.zeros(0, np.float32)), np.float32
        ).copy()
        ich = int(state.get("interleave_channels", 0))
        self._interleave_channels = ich if ich > 0 else None

    def save_state(self, path) -> None:
        np.savez(path, **self.get_state())

    def load_state(self, path) -> None:
        with np.load(path) as data:
            self.set_state({k: data[k] for k in data.files})
