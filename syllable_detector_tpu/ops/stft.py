"""Framed short-time Fourier transform, GEMM-native.

The reference implements a *streaming* STFT over a lock-free ring buffer,
computing one vDSP radix-2 real FFT per hop (reference:
Common/CircularShortTimeFourierTransform.swift:280-337). On an accelerator
the idiomatic design is batched and GEMM-native: gather hop-strided windows into a frame
matrix and compute only the frequency band the detector needs as two real
matmuls against a windowed band-limited DFT matrix — window multiply, zero
padding, FFT, and band slice all fold into a single matmul.

Numerics replicated from the reference:

  * ``extractPower`` (the path the detector uses,
    Common/SyllableDetector.swift:136) returns the plain magnitude |X_k| of
    the standard DFT: vDSP's real FFT produces 2*DFT, then zvabs/2 cancels the
    packing scale (CircularShortTimeFourierTransform.swift:311-334).
  * ``extractMagnitude`` — despite the name — returns |X_k|^2 via zvmags/4
    (CircularShortTimeFourierTransform.swift:252-277). The names are swapped
    in the reference; here ``kind='magnitude'`` means |X| and ``kind='power'``
    means |X|^2, with the detector using *magnitude*.
  * the packed Nyquist bin is zeroed before conversion, so outputs cover bins
    [0, fft_len/2) — DC through below-Nyquist
    (CircularShortTimeFourierTransform.swift:263-264).
  * a negative overlap is a gap: each window skips ``gap`` samples first, and
    the gap applies to the very first window too
    (CircularShortTimeFourierTransform.swift:65-73, 235-237).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from syllable_detector_tpu.ops.windows import make_window

__all__ = [
    "normalize_overlap",
    "num_frames",
    "frame_signal",
    "frame_start_indices",
    "band_dft_matrices",
    "spectral_frames",
    "stack_features",
    "frequency_index_range",
    "frequencies_for_sample_rate",
]


def normalize_overlap(window_overlap: int) -> tuple[int, int]:
    """Split a raw windowOverlap into (gap, overlap): negative overlap is a
    gap (CircularShortTimeFourierTransform.swift:65-73)."""
    if window_overlap < 0:
        return -window_overlap, 0
    return 0, window_overlap


def hop_length(window_length: int, window_overlap: int) -> int:
    gap, overlap = normalize_overlap(window_overlap)
    return gap + window_length - overlap


def num_frames(n_samples: int, window_length: int, window_overlap: int) -> int:
    """How many spectral frames a buffer of ``n_samples`` yields.

    Each extraction requires ``gap + window`` available samples and consumes
    ``gap + window - overlap``
    (CircularShortTimeFourierTransform.swift:286-301).
    """
    gap, _ = normalize_overlap(window_overlap)
    hop = hop_length(window_length, window_overlap)
    need = gap + window_length
    if n_samples < need:
        return 0
    return 1 + (n_samples - need) // hop


def frame_start_indices(
    n_frames: int, window_length: int, window_overlap: int
) -> np.ndarray:
    """Sample index of the first sample inside each window (after the gap)."""
    gap, _ = normalize_overlap(window_overlap)
    hop = hop_length(window_length, window_overlap)
    return gap + hop * np.arange(n_frames, dtype=np.int64)


def slab_parts(
    window_length: int, window_overlap: int
) -> tuple[int, int, list[tuple[int, int, int]]]:
    """Slab decomposition of hop-strided framing: frame k's column block j
    is row ``k + j`` of the ``[rows, hop]`` reshape of the raw samples.

    Returns (gap, hop, parts) with parts = [(frame col lo, frame col hi,
    slab col lo), ...] — the single home for this geometry; frame_signal and
    and the polyphase resampler (ops/resample.py) delegate here.
    """
    gap, _ = normalize_overlap(window_overlap)
    hop = hop_length(window_length, window_overlap)
    n_parts = -(-(gap + window_length) // hop)
    parts = []
    for j in range(n_parts):
        lo = max(0, j * hop - gap)
        hi = min(window_length, (j + 1) * hop - gap)
        parts.append((lo, hi, gap + lo - j * hop))
    return gap, hop, parts


def frame_signal(
    x: jax.Array, n_frames: int, window_length: int, window_overlap: int
) -> jax.Array:
    """Extract hop-strided overlapping windows: [n] -> [n_frames, window].

    ``n_frames`` must be static (precomputed with :func:`num_frames`) so the
    output shape is known at trace time.

    Implementation note: built from static slices of a ``[rows, hop]``
    reshape, NOT a gather: slice+concat compiles to plain copies, while a
    gather that must materialize (e.g. to feed a matmul) can lower to a far
    slower loop.
    Frame k's column block j is row k+j of the hop-strided slab.
    """
    _, hop, part_geo = slab_parts(window_length, window_overlap)
    rows2d = n_frames + len(part_geo) - 1
    total = rows2d * hop
    n = x.shape[0]
    if total > n:
        x = jnp.concatenate([x, jnp.zeros(total - n, x.dtype)])
    slab = x[:total].reshape(rows2d, hop)
    parts = [
        slab[j : j + n_frames, clo : clo + (hi - lo)]
        for j, (lo, hi, clo) in enumerate(part_geo)
    ]
    return jnp.concatenate(parts, axis=1)


def band_dft_matrices(
    fft_length: int,
    window_length: int,
    window_type: str = "hamming",
    bins: tuple[int, int] | None = None,
    dtype=np.float32,
) -> tuple[np.ndarray, np.ndarray]:
    """Windowed band-limited real-DFT matrices.

    Returns (C_re, C_im), each [window_length, n_bins], such that for a frame
    row vector x: ``re = x @ C_re`` and ``im = x @ C_im`` give the real and
    imaginary parts of DFT bins [lo, hi) of the zero-padded windowed frame.
    Window multiply, zero-padding to fft_length, and the band slice are all
    folded into the matrix — one GEMM pair replaces the reference's per-hop
    vDSP_vmul + vDSP_fft_zript + slice
    (CircularShortTimeFourierTransform.swift:311-334).
    """
    lo, hi = bins if bins is not None else (0, fft_length // 2)
    w = make_window(window_type, window_length, dtype=np.float64)
    n = np.arange(window_length, dtype=np.float64)[:, None]
    k = np.arange(lo, hi, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / fft_length
    c_re = (w[:, None] * np.cos(ang)).astype(dtype)
    c_im = (-w[:, None] * np.sin(ang)).astype(dtype)
    return c_re, c_im


@partial(jax.jit, static_argnames=("kind", "precision"))
def _frames_to_band(
    frames: jax.Array,
    c_cat: jax.Array,
    kind: str = "magnitude",
    precision: str = "highest",
) -> jax.Array:
    """frames @ [c_re | c_im] as ONE GEMM, then |X| or |X|^2.

    Packing re and im side by side makes one launch of one wider GEMM
    instead of two narrow ones (N=58 instead of 2 x N=29 at the sample
    geometry).
    """
    prec = jax.lax.Precision(precision.lower())
    b = c_cat.shape[1] // 2
    big = jnp.matmul(frames, c_cat, precision=prec)
    re = big[..., :b]
    im = big[..., b:]
    sq = re * re + im * im
    if kind == "power":
        return sq
    return jnp.sqrt(sq)


def spectral_frames(
    frames: jax.Array,
    fft_length: int,
    window_type: str = "hamming",
    bins: tuple[int, int] | None = None,
    kind: str = "magnitude",
    method: str = "matmul",
    precision: str = "highest",
) -> jax.Array:
    """[F, window] frames -> [F, n_bins] magnitude (|X|) or power (|X|^2).

    ``method='matmul'`` is the GEMM-native path; ``method='rfft'`` keeps
    a full jnp.fft.rfft for cross-validation and wide-band use.
    """
    window_length = frames.shape[-1]
    lo, hi = bins if bins is not None else (0, fft_length // 2)
    if kind not in ("magnitude", "power"):
        raise ValueError("kind must be 'magnitude' or 'power'")
    if method == "matmul":
        c_re, c_im = band_dft_matrices(
            fft_length, window_length, window_type, (lo, hi)
        )
        c_cat = np.concatenate([c_re, c_im], axis=1)
        return _frames_to_band(
            frames, jnp.asarray(c_cat), kind=kind, precision=precision
        )
    elif method == "rfft":
        w = jnp.asarray(make_window(window_type, window_length))
        spec = jnp.fft.rfft(frames * w[None, :], n=fft_length, axis=-1)
        mag = jnp.abs(spec[..., lo:hi])
        return mag * mag if kind == "power" else mag
    raise ValueError(f"unknown method {method!r}")


def stack_features(band: jax.Array, time_range: int) -> jax.Array:
    """[F, B] band frames -> [F - T + 1, T*B] feature vectors.

    Feature layout is freq-fastest, time-major: the flattened concatenation of
    ``time_range`` consecutive frames, oldest first — exactly the view the
    reference takes over its feature ring buffer
    (Common/SyllableDetector.swift:158-180). The sliding window advances one
    frame per evaluation (SyllableDetector.swift:174-178).
    """
    n_frames, n_bins = band.shape
    n_evals = n_frames - time_range + 1
    if n_evals <= 0:
        return jnp.zeros((0, time_range * n_bins), band.dtype)
    # static shifted slices, not a gather (see frame_signal's note): column
    # block t of eval e is frame e+t
    return jnp.concatenate(
        [band[t : t + n_evals, :] for t in range(time_range)], axis=1
    )


def frequency_index_range(
    fft_length: int, start_freq: float, end_freq: float, sample_rate: float
) -> tuple[int, int] | None:
    """Band bin range [start, end) for a frequency interval.

    start = ceil(fft/rate * f0); end = floor(fft/rate * f1) + 1 clamped to
    fft/2 (CircularShortTimeFourierTransform.swift:166-191). Returns None for
    out-of-range inputs, like the reference.
    """
    if not (start_freq >= 0.0 and end_freq > start_freq):
        return None
    half = fft_length // 2
    from_frequency = float(fft_length) / float(sample_rate)
    start = int(math.ceil(from_frequency * start_freq))
    if start >= half:
        return None
    end = int(math.floor(from_frequency * end_freq)) + 1
    if end < start:
        return None
    if end > half:
        return start, half
    return start, end


def frequencies_for_sample_rate(fft_length: int, sample_rate: float) -> np.ndarray:
    """Center frequency of each retained bin
    (CircularShortTimeFourierTransform.swift:160-164)."""
    half = fft_length // 2
    return np.arange(half, dtype=np.float64) * (float(sample_rate) / fft_length)
