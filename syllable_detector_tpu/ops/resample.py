"""Sample-rate conversion.

Two implementations:

  * :func:`linear_resample_chunk` — a bit-matching port of the reference's
    streaming linear interpolator ``ResamplerLinear``
    (reference: Common/Resampler.swift:20-76): float32 index ramp
    (vDSP_vramp), table-lookup interpolation (vDSP_vlint), and the
    fractional ``offset`` / ``last``-sample carry that makes the stream
    seamless across arbitrary chunk boundaries, including the
    interpolate-across-the-boundary branch when ``offset < 0``. Host-side
    numpy — this is the fidelity oracle and the live-path default, exactly
    as the reference instantiates it only for rate-mismatched devices
    (ViewControllerProcessor.swift:247-250). Self-described in the
    reference as "Terrible quality, very fast" (Resampler.swift:19).

  * :func:`polyphase_resample` — the batched quality path: a
    windowed-sinc polyphase FIR evaluated as one batched contraction
    (gather windows -> einsum against a per-phase filter bank), so the
    whole conversion is a single fused XLA computation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from syllable_detector_tpu.ops.stft import frame_signal

__all__ = [
    "LinearResamplerState",
    "linear_resample_init",
    "linear_resample_chunk",
    "linear_resample_chunk_exact",
    "linear_resample",
    "polyphase_resample",
    "polyphase_filter_bank",
]


# ---------------------------------------------------------------------------
# streaming linear interpolation (fidelity path)
# ---------------------------------------------------------------------------


@dataclass
class LinearResamplerState:
    """Carry across chunks (Resampler.swift:25-26)."""

    step: np.float32  # in_rate / out_rate, float32 like the reference
    last: np.float32 = np.float32(0.0)
    offset: np.float32 = np.float32(0.0)
    step64: float = 0.0  # full-precision step, used by the exact variant


def linear_resample_init(in_rate: float, out_rate: float) -> LinearResamplerState:
    # step computed in double then narrowed, like Float(samplingRateIn /
    # samplingRateOut) (Resampler.swift:32)
    ratio = float(in_rate) / float(out_rate)
    return LinearResamplerState(step=np.float32(ratio), step64=ratio)


def linear_resample_chunk(
    data: np.ndarray, state: LinearResamplerState
) -> tuple[np.ndarray, LinearResamplerState]:
    """Resample one chunk, updating the carried state.

    Mirrors ResamplerLinear.resampleVector (Resampler.swift:35-70) bit for
    bit, float32 arithmetic included — *including* two reference quirks kept
    for fidelity:

      * one-sample-per-chunk position drift: the carried ``offset`` is
        rebased to sample ``n-1`` (Resampler.swift:65) while the next chunk's
        first sample is global position ``n``, so every chunk boundary skips
        one input sample position (harmless for its live use with
        near-matching device rates);
      * when the interpolate-across branch fires, ``indices[0]`` is mutated
        to 0 *before* the carry reads ``indices[numOut-1]``
        (Resampler.swift:54-65), shifting the carry when numOut == 1.

    Use :func:`linear_resample_chunk_exact` for drift-free streaming.
    """
    data = np.ascontiguousarray(data, dtype=np.float32)
    n = data.shape[0]
    if n == 0:
        return np.zeros(0, np.float32), state

    step = np.float32(state.step)
    offset = np.float32(state.offset)

    interpolate_across = bool(offset < 0)

    num_out = int((np.float32(n) - offset) / step)
    if num_out <= 0:
        # Not enough input to emit a sample; the reference never hits this
        # (reads indices[-1], UB) — carry the offset gracefully instead.
        new_state = LinearResamplerState(
            step=step,
            last=np.float32(data[n - 1]),
            offset=np.float32(offset - np.float32(n - 1)),
        )
        return np.zeros(0, np.float32), new_state

    # vDSP_vramp: indices[k] = offset + k*step, float32 (Resampler.swift:52)
    indices = offset + np.arange(num_out, dtype=np.float32) * step
    if interpolate_across:
        indices = indices.copy()
        indices[0] = np.float32(0.0)

    # vDSP_vlint: out[k] = d[j] + frac*(d[j+1]-d[j]), j = floor(idx)
    # (Resampler.swift:59). Clamp the j+1 lookup at the final sample for
    # fractional indices beyond n-1 (only reachable when upsampling).
    out = _vlint(data, indices)

    if interpolate_across:
        # ret[0] = last*(0-offset) + data[0]*(1+offset) (Resampler.swift:62)
        out[0] = np.float32(state.last) * (np.float32(0.0) - offset) + data[0] * (
            np.float32(1.0) + offset
        )

    new_offset = np.float32(indices[num_out - 1] + step - np.float32(n - 1))
    new_state = LinearResamplerState(
        step=step, last=np.float32(data[n - 1]), offset=new_offset
    )
    return out, new_state


def _vlint(data: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """vDSP_vlint: table-lookup linear interpolation, clamped at the ends."""
    n = data.shape[0]
    j = np.clip(np.floor(indices).astype(np.int64), 0, n - 1)
    j1 = np.minimum(j + 1, n - 1)
    frac = (indices - j.astype(indices.dtype)).astype(np.float32)
    d0 = data[j]
    return (d0 + frac * (data[j1] - d0)).astype(np.float32)


def linear_resample_chunk_exact(
    data: np.ndarray, state: LinearResamplerState
) -> tuple[np.ndarray, LinearResamplerState]:
    """Drift-free streaming linear interpolation (the runtime default).

    Same interpolation math as the reference, but the fractional position is
    carried in float64 relative to the true next-sample origin, so streaming
    any chunking equals resampling the whole stream at once (up to float32
    interpolation rounding).
    """
    data = np.ascontiguousarray(data, dtype=np.float32)
    n = data.shape[0]
    if n == 0:
        return np.zeros(0, np.float32), state

    step = state.step64 if state.step64 else float(state.step)
    offset = float(state.offset)

    interpolate_across = offset < 0

    # emit positions <= n-1; anything in (n-1, n) defers to the next chunk's
    # interpolate-across blend
    num_out = int((n - 1 - offset) / step) + 1 if offset <= n - 1 else 0
    if num_out <= 0:
        new_state = LinearResamplerState(
            step=state.step,
            last=np.float32(data[n - 1]),
            offset=offset - n,
            step64=step,
        )
        return np.zeros(0, np.float32), new_state

    positions = offset + np.arange(num_out, dtype=np.float64) * step
    lookup = positions.copy()
    if interpolate_across:
        lookup[0] = 0.0
    out = _vlint(data, lookup)
    if interpolate_across:
        out[0] = np.float32(state.last) * np.float32(-offset) + data[0] * np.float32(
            1.0 + offset
        )

    new_offset = positions[num_out - 1] + step - n
    new_state = LinearResamplerState(
        step=state.step,
        last=np.float32(data[n - 1]),
        offset=new_offset,
        step64=step,
    )
    return out, new_state


def linear_resample(data: np.ndarray, in_rate: float, out_rate: float) -> np.ndarray:
    """Whole-array convenience wrapper (Resampler.swift:72-76)."""
    out, _ = linear_resample_chunk(data, linear_resample_init(in_rate, out_rate))
    return out


# ---------------------------------------------------------------------------
# polyphase FIR (quality path, fully batched)
# ---------------------------------------------------------------------------


def _kaiser_sinc_filter(up: int, down: int, half_width: int, beta: float) -> np.ndarray:
    """Lowpass FIR on the up-sampled grid, cutoff Nyquist/max(up, down)."""
    max_rate = max(up, down)
    numtaps = 2 * half_width * max_rate + 1
    n = np.arange(numtaps, dtype=np.float64) - (numtaps - 1) / 2.0
    cutoff = 1.0 / max_rate  # fraction of Nyquist on the upsampled grid
    h = cutoff * np.sinc(cutoff * n)
    h *= np.kaiser(numtaps, beta)
    # normalize DC gain to `up` so amplitudes survive zero-stuffing
    h = h / np.sum(h) * up
    return h


def polyphase_filter_bank(
    up: int, down: int, half_width: int = 10, beta: float = 5.0
) -> tuple[np.ndarray, int]:
    """Per-phase filter bank Hb[up, taps] and the filter's group delay
    (in upsampled samples)."""
    h = _kaiser_sinc_filter(up, down, half_width, beta)
    half = (len(h) - 1) // 2
    taps = int(math.ceil(len(h) / up))
    hb = np.zeros((up, taps), dtype=np.float64)
    for p in range(up):
        sub = h[p::up]
        hb[p, : len(sub)] = sub
    return hb.astype(np.float32), half


def polyphase_plan(up: int, down: int, half_width: int = 10, beta: float = 5.0):
    """Framing plan that turns rational resampling into one framed GEMM.

    Output k (= a*up + r) reads the input window ending at m = base//up with
    phase base % up, where base = k*down + half on the upsampled grid. Block
    a's windows for every phase live inside one contiguous input span of
    width W = (max-min window end) + taps, so the whole resampler is
    hop-strided framing (the slab method — static slices, never a gather
    feeding a matmul) followed by a
    single [blocks, W] @ [W, up] contraction against a filter matrix with
    each phase's taps scattered at its own offsets.

    Returns (g [W, up] float32, lead, w_len, overlap): frame the input
    (left-padded/trimmed by ``lead``) with window ``w_len`` and
    ``overlap`` (negative = gap), then ``frames @ g`` and flatten.
    """
    hb, half = polyphase_filter_bank(up, down, half_width, beta)
    taps = hb.shape[1]
    r = np.arange(up, dtype=np.int64)
    base_r = r * down + half
    phase = base_r % up
    m_off = base_r // up

    # frame a covers input positions [a*down + start0, a*down + start0 + W)
    # (in unpadded x coordinates); tap t of phase r reads column
    # m_off[r] - t - start0
    start0 = int(m_off.min()) - (taps - 1)
    w_len = int(m_off.max()) - start0 + 1

    g = np.zeros((w_len, up), np.float32)
    for rr in range(up):
        for t in range(taps):
            g[int(m_off[rr]) - t - start0, rr] = hb[phase[rr], t]

    # align frame_signal's gap offset (negative overlap) with start0
    overlap = w_len - down
    gshift = max(0, down - w_len)
    lead = gshift - start0
    return g, lead, w_len, overlap


def _polyphase_lead(x, lead):
    if lead > 0:
        return jnp.concatenate([jnp.zeros(lead, x.dtype), x])
    if lead < 0:
        return x[-lead:]
    return x


@partial(jax.jit, static_argnames=("up", "down", "half_width", "beta", "n_out"))
def _polyphase_apply(x, up, down, half_width, beta, n_out):
    """All `up` phases of one output block as ONE GEMM (see polyphase_plan)."""
    g, lead, w_len, overlap = polyphase_plan(up, down, half_width, beta)
    blocks = -(-n_out // up)
    xin = _polyphase_lead(x, lead)
    # frame_signal zero-pads the back as needed for `blocks` frames
    frames = frame_signal(xin, blocks, w_len, overlap)
    y = jnp.matmul(frames, jnp.asarray(g), precision=jax.lax.Precision.HIGHEST)
    return y.reshape(-1)[:n_out]


def polyphase_resample(
    x,
    in_rate: float,
    out_rate: float,
    half_width: int = 10,
    beta: float = 5.0,
    max_denominator: int = 1000,
) -> jax.Array:
    """High-quality rational resampling as one fused XLA computation.

    The rate ratio is approximated as a fraction (e.g. 96k -> 44.1k is
    147/320); the result matches scipy.signal.resample_poly's upfirdn
    semantics with a Kaiser(beta) windowed-sinc design.
    """
    frac = Fraction(float(out_rate) / float(in_rate)).limit_denominator(
        max_denominator
    )
    up, down = frac.numerator, frac.denominator
    x = jnp.asarray(x, jnp.float32)
    n = x.shape[0]
    if up == down:
        return x
    n_out = -(-n * up // down)
    return _polyphase_apply(x, up, down, half_width, beta, n_out)
