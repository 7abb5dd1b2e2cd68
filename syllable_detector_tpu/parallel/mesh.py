"""Mesh-sharded multi-channel detection.

Maps the reference's channel fan-out (one SyllableDetector per channel,
Processor.swift:57-59) onto devices: channels are a leading batch axis,
vmapped on each device and sharded across the mesh's ``channel`` axis. Distinct
per-channel networks ride along as stacked parameter pytrees
(models/neural_net.stack_params). Aggregate metrics reduce with ``psum``
over the mesh — the only cross-device communication this workload needs
(SURVEY.md section 2, parallelism table).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from syllable_detector_tpu.models.detector import (
    WINDOW,
    DetectorSpec,
    offline_outputs,
    streaming_step,
)

__all__ = [
    "make_mesh",
    "batch_offline_outputs",
    "sharded_offline_outputs",
    "sharded_detection_counts",
    "sharded_streaming_step",
    "time_sharded_offline_outputs",
    "tensor_sharded_offline_outputs",
]

CHANNEL_AXIS = "channel"
TIME_AXIS = "time"


def make_mesh(n_devices: int | None = None, axis: str = CHANNEL_AXIS) -> Mesh:
    """1-D device mesh over the first ``n_devices`` devices."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


@partial(jax.jit, static_argnames=("spec", "method"))
def batch_offline_outputs(
    spec: DetectorSpec, stacked_params, xs: jax.Array, method: str = "matmul"
) -> jax.Array:
    """[C, n] streams + stacked per-channel params -> [C, E, outputs]."""
    return jax.vmap(lambda p, x: offline_outputs(spec, p, x, method=method))(
        stacked_params, xs
    )


def sharded_offline_outputs(
    mesh: Mesh,
    spec: DetectorSpec,
    stacked_params,
    xs: jax.Array,
    method: str = "matmul",
) -> jax.Array:
    """Shard the channel axis across the mesh; each device runs its local
    channels with zero cross-device communication."""
    axis = mesh.axis_names[0]

    def local(params, x):
        return batch_offline_outputs(spec, params, x, method=method)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=P(axis),
    )
    return jax.jit(fn)(stacked_params, xs)


def sharded_detection_counts(
    mesh: Mesh, spec: DetectorSpec, stacked_params, xs: jax.Array
) -> jax.Array:
    """Global detection count per output via psum — the cross-device metrics
    reduction (the multi-device analogue of SummaryStat aggregation)."""
    axis = mesh.axis_names[0]
    thresholds = jnp.asarray(spec.thresholds, jnp.float32)

    def local(params, x):
        outs = batch_offline_outputs(spec, params, x)  # [c_local, E, O]
        hits = jnp.sum(outs >= thresholds, axis=(0, 1)).astype(jnp.int32)
        return jax.lax.psum(hits, axis)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=P(),
    )
    return jax.jit(fn)(stacked_params, xs)


from collections import OrderedDict

# memoized per-(spec, params, mesh) setups: the numpy constant folds and
# the jitted shard_map callables both survive across calls (a fresh
# jax.jit(shard_map(...)) per invocation would retrace every time).
# Bounded LRU; values hold a strong params reference so ids stay valid.
_tp_const_cache: "OrderedDict" = OrderedDict()
_sharded_fn_cache: "OrderedDict" = OrderedDict()
_SHARDED_CACHE_MAX = 32


def _lru_get(cache, key, build, params_ref):
    hit = cache.get(key)
    if hit is not None and hit[1] is params_ref:
        cache.move_to_end(key)
        return hit[0]
    value = build()
    cache[key] = (value, params_ref)
    while len(cache) > _SHARDED_CACHE_MAX:
        cache.popitem(last=False)
    return value


def _tp_constants(spec: DetectorSpec, params, d: int):
    """Device-sharded constants for tensor_sharded_offline_outputs
    (numpy fold; memoized — the triple loop only ever runs once per
    (spec, params, mesh size))."""
    from syllable_detector_tpu.ops.processing import (
        fold_input_affines,
        fold_output_affines,
    )
    from syllable_detector_tpu.ops.stft import band_dft_matrices

    b = spec.n_bins
    t_range = spec.time_range
    bp = -(-b // d)  # bins per device (zero-padded shards)

    c_re, c_im = band_dft_matrices(
        spec.fourier_length, spec.window_length, WINDOW, spec.bins
    )
    c_re_p = np.zeros((spec.window_length, d * bp), np.float32)
    c_im_p = np.zeros((spec.window_length, d * bp), np.float32)
    c_re_p[:, :b] = c_re
    c_im_p[:, :b] = c_im
    c_re_s = np.stack(np.split(c_re_p, d, axis=1))  # [d, window, bp]
    c_im_s = np.stack(np.split(c_im_p, d, axis=1))

    scale, shift, has_l2 = fold_input_affines(
        spec.net.input_processing, params["process_inputs"], t_range * b
    )
    w1 = np.asarray(params["layers"][0]["w"], np.float64)  # [H, D_feats]
    h1 = w1.shape[0]
    w1_eff = w1 * scale[None, :]
    b_eff = np.asarray(params["layers"][0]["b"], np.float64) + w1 @ shift

    # local W1 columns: shard dd owns features (t, dd*bp + j) for all t
    w1_s = np.zeros((d, t_range * bp, h1), np.float32)
    for dd in range(d):
        for j in range(min(bp, b - dd * bp)):
            gbin = dd * bp + j
            for t in range(t_range):
                w1_s[dd, t * bp + j, :] = w1_eff[:, t * b + gbin]
    mask = np.zeros((d, bp), np.float32)
    for dd in range(d):
        mask[dd, : max(0, min(bp, b - dd * bp))] = 1.0

    mids = [
        (np.asarray(l["w"], np.float32).T, np.asarray(l["b"], np.float32))
        for l in params["layers"][1:]
    ]
    out_a, out_c = fold_output_affines(
        spec.net.output_processing, params["process_outputs"], spec.net.outputs
    )
    return (
        c_re_s, c_im_s, w1_s, mask, has_l2, tuple(mids),
        out_a.astype(np.float32), out_c.astype(np.float32),
        b_eff.astype(np.float32),
    )


def tensor_sharded_offline_outputs(
    mesh: Mesh,
    spec: DetectorSpec,
    params,
    x: jax.Array,
) -> jax.Array:
    """One detector's FEATURE axis sharded across the mesh — tensor
    parallelism for this workload: each device computes the band DFT for its
    shard of frequency bins and its columns of the (affine-folded) first
    layer, and ONE ``psum`` reduces the partial layer-1 products (plus the
    l2-norm partial sums) across devices. Everything after layer 1 is a few
    hundred FLOPs and runs replicated.

    The algebra: with the input chain folded to ``x*scale + shift``
    (ops.processing.fold_input_affines) and l2normalize linear in the
    contraction, ``W1 @ chain(feat) = psum_d(W1_d' @ feat_d)/||feat|| +
    (b1 + W1 @ shift)``. Numerically matches
    :func:`~syllable_detector_tpu.models.detector.offline_outputs`; falls
    back to it for unsupported processing chains. The constant fold and the
    jitted shard_map callable are memoized per (spec, params, mesh, frame
    count) — repeated calls do no numpy work and no retracing.
    """
    from syllable_detector_tpu.models.detector import fusable
    from syllable_detector_tpu.ops.stft import num_frames, stack_features
    from syllable_detector_tpu.ops.transfer import apply_transfer

    if not fusable(spec):
        return offline_outputs(spec, params, x)

    axis = mesh.axis_names[0]
    d = int(mesh.shape[axis])
    t_range = spec.time_range

    consts = _lru_get(
        _tp_const_cache,
        (spec, id(params), d),
        lambda: _tp_constants(spec, params, d),
        params,
    )
    (c_re_s, c_im_s, w1_s, mask, has_l2, mids, out_a, out_c, b_eff32) = consts

    n = int(x.shape[0])
    f = num_frames(n, spec.window_length, spec.window_overlap)
    n_evals = f - t_range + 1
    if n_evals <= 0:
        return jnp.zeros((0, spec.net.outputs), jnp.float32)

    hi_prec = jax.lax.Precision.HIGHEST
    scaling = spec.scaling
    transfers = spec.net.transfers

    def build_fn():
        def local(c_re_l, c_im_l, w1_l, mask_l, x):
            c_re_l, c_im_l = c_re_l[0], c_im_l[0]
            w1_l, mask_l = w1_l[0], mask_l[0]
            from syllable_detector_tpu.ops.stft import frame_signal

            frames = frame_signal(x, f, spec.window_length, spec.window_overlap)
            re = jnp.matmul(frames, c_re_l, precision=hi_prec)
            im = jnp.matmul(frames, c_im_l, precision=hi_prec)
            mag = jnp.sqrt(re * re + im * im)
            if scaling == "db":
                s = jnp.where(mask_l > 0, 20.0 * jnp.log10(mag), 0.0)
            elif scaling == "log":
                s = jnp.where(mask_l > 0, jnp.log(mag), 0.0)
            else:
                s = mag
            feats = stack_features(s, t_range)  # [E, T*bp]
            z = jnp.matmul(feats, w1_l, precision=hi_prec)  # local partial
            z = jax.lax.psum(z, axis)  # the ONE tp collective
            if has_l2:
                rowsq = jax.lax.psum(
                    jnp.sum(feats * feats, axis=1, keepdims=True), axis
                )
                z = z / jnp.sqrt(rowsq)
            h = apply_transfer(z + b_eff32, transfers[0])
            for (w, bb), name in zip(mids, transfers[1:]):
                h = apply_transfer(
                    jnp.matmul(h, w, precision=hi_prec) + bb, name
                )
            return h * out_a + out_c

        return jax.jit(
            jax.shard_map(
                local,
                mesh=mesh,
                in_specs=(P(axis), P(axis), P(axis), P(axis), P()),
                out_specs=P(),
            )
        )

    fn = _lru_get(
        _sharded_fn_cache,
        ("tp", spec, id(params), mesh, f),
        build_fn,
        params,
    )
    return fn(
        jnp.asarray(c_re_s), jnp.asarray(c_im_s), jnp.asarray(w1_s),
        jnp.asarray(mask), jnp.asarray(x, jnp.float32),
    )


def time_sharded_offline_outputs(
    mesh: Mesh,
    spec: DetectorSpec,
    params,
    x: jax.Array,
    method: str = "matmul",
) -> jax.Array:
    """One long stream's TIME axis sharded across the mesh — the
    sequence-parallel form of this workload (SURVEY.md section 5: "shard the
    time axis across devices with halo exchange of window-hop samples").

    Each device evaluates a contiguous block of hops from its local segment
    plus a ``(timeRange-2)*hop + gap + window`` sample halo received from its
    right neighbor over one ``lax.ppermute``; the last device takes the
    zero-padded stream tail instead. Numerically identical to
    :func:`~syllable_detector_tpu.models.detector.offline_outputs` on the
    whole stream. Use for offline corpus scans whose single stream is too
    long for one device's HBM; channel-parallel sharding remains the
    deployment shape for many independent streams.
    """
    from syllable_detector_tpu.ops.stft import normalize_overlap, num_frames

    axis = mesh.axis_names[0]
    d = int(mesh.shape[axis])
    gap, _ = normalize_overlap(spec.window_overlap)
    hop = spec.hop
    halo = (spec.time_range - 2) * hop + gap + spec.window_length

    n = int(x.shape[0])
    f = num_frames(n, spec.window_length, spec.window_overlap)
    e_total = f - spec.time_range + 1
    if e_total <= 0:
        return jnp.zeros((0, spec.net.outputs), jnp.float32)
    e_loc = -(-e_total // d)
    if e_loc * hop < halo:
        # segments shorter than the halo cannot feed the neighbor exchange;
        # the stream is too short to be worth sharding anyway
        return offline_outputs(spec, params, x, method=method)

    body = d * e_loc * hop
    need = body + halo
    x = jnp.asarray(x, jnp.float32)
    if need > n:
        x = jnp.concatenate([x, jnp.zeros(need - n, jnp.float32)])
    xs = x[:body].reshape(d, e_loc * hop)
    tail = x[body:need]  # the last device's halo lives in the stream tail

    perm = [((i + 1) % d, i) for i in range(d)]  # receive from right neighbor

    def build_fn():
        def local(x_own, tail, p):
            x_own = x_own[0]
            idx = jax.lax.axis_index(axis)
            from_right = jax.lax.ppermute(x_own[:halo], axis, perm)
            halo_recv = jnp.where(idx == d - 1, tail, from_right)
            seg = jnp.concatenate([x_own, halo_recv])
            # params ride as TRACED replicated arguments
            return offline_outputs(spec, p, seg, method=method)

        return jax.jit(
            jax.shard_map(
                local,
                mesh=mesh,
                in_specs=(P(axis), P(), P()),
                out_specs=P(axis),
            )
        )

    fn = _lru_get(
        _sharded_fn_cache,
        ("sp", spec, id(params), mesh, method, e_loc),
        build_fn,
        params,
    )
    outs = fn(xs, tail, params)  # [d*e_loc, outputs]
    return outs[:e_total]


def sharded_streaming_step(
    mesh: Mesh,
    spec: DetectorSpec,
    stacked_params,
    carries,
    chunks: jax.Array,
):
    """One fixed-shape streaming step for all channels, sharded over the mesh.

    ``carries`` is the stacked streaming carry ([C, ...] leaves from
    models.detector.streaming_init); ``chunks`` is [C, H*hop]. Returns
    (new_carries, outputs [C, H, outputs]).
    """
    axis = mesh.axis_names[0]

    def local(params, carry, chunk):
        return jax.vmap(lambda p, c, x: streaming_step(spec, p, c, x))(
            params, carry, chunk
        )

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis)),
    )
    return jax.jit(fn)(stacked_params, carries, chunks)
