"""Batched offline corpus scan: many files, one shared network, one device
computation.

The reference CLI iterates files sequentially, one detector per track
(reference: SyllableDetectorCLI/main.swift:63-131). The batched corpus
path pads all streams to a shared bucket length, stacks them on a batch axis,
and runs the whole corpus through one vmapped (optionally mesh-sharded)
detection call — the "batched offline corpus scan" deployment shape.
Per-file sample accounting and debounce reproduce TrackDetector's semantics
(TrackDetector.swift:45-105).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from syllable_detector_tpu.config.model_format import SyllableDetectorConfig
from syllable_detector_tpu.models.detector import (
    DetectorSpec,
    detector_spec_from_config,
    offline_outputs,
)
from syllable_detector_tpu.ops.stft import num_frames
from syllable_detector_tpu.utils.fmt import fmt_double, fmt_float32
from syllable_detector_tpu.utils.wav import read_audio

__all__ = [
    "batch_offline_outputs_shared",
    "sharded_batch_offline_outputs_shared",
    "scan_corpus",
    "corpus_csv_lines",
    "scan_corpus_files",
]


@partial(jax.jit, static_argnames=("spec", "method"))
def _batch(spec: DetectorSpec, params, xs: jax.Array, method: str):
    return jax.vmap(
        lambda x: offline_outputs(spec, params, x, method=method)
    )(xs)


@partial(jax.jit, static_argnames=("spec", "method"))
def _batch_distinct(
    spec: DetectorSpec, stacked, xs: jax.Array, method: str
):
    return jax.vmap(
        lambda p, x: offline_outputs(spec, p, x, method=method)
    )(stacked, xs)


def batch_offline_outputs_shared(
    spec: DetectorSpec, params, xs: jax.Array, method: str = "matmul"
) -> jax.Array:
    """[C, n] streams -> [C, E, outputs].

    ``params`` is ONE shared network (dict) or a sequence of C DISTINCT
    per-lane networks sharing the spec's geometry (the reference's
    one-net-per-channel deployment, Processor.swift:57-59).
    ``method`` picks the spectral backend ('matmul' or 'rfft').
    """
    if isinstance(params, (list, tuple)):
        from syllable_detector_tpu.models.neural_net import stack_params

        return _batch_distinct(
            spec, stack_params(list(params)), xs, method
        )
    return _batch(spec, params, xs, method)


from collections import OrderedDict

# bounded LRU so long-lived servers don't accumulate specs for dead configs
_spec_memo: "OrderedDict" = OrderedDict()
_SPEC_MEMO_MAX = 16


def _spec_cache(cfg: SyllableDetectorConfig):
    """Reuse (spec, params) across calls for the same config object so the
    jit caches stay warm (holds a strong cfg reference so the
    id cannot be recycled)."""
    key = id(cfg)
    hit = _spec_memo.get(key)
    if hit is None or hit[2] is not cfg:
        spec, params = detector_spec_from_config(cfg)
        _spec_memo[key] = (spec, params, cfg)
        while len(_spec_memo) > _SPEC_MEMO_MAX:
            _spec_memo.popitem(last=False)
        hit = _spec_memo[key]
    else:
        _spec_memo.move_to_end(key)
    return hit[0], hit[1]


def _bucket(n: int) -> int:
    """Round stream length up to limit distinct compiled shapes."""
    b = 1 << 14
    while b < n:
        b <<= 1
    return b


def sharded_batch_offline_outputs_shared(
    mesh, spec: DetectorSpec, params, xs: jax.Array, method: str = "matmul"
) -> jax.Array:
    """[C, n] streams sharded over the mesh's first axis -> [C, E, outputs].
    ``params``: one shared net (replicated per device) or C distinct
    per-lane nets (sharded with their lanes). C must divide by the mesh
    size (scan_corpus pads). No cross-device communication — lanes are
    embarrassingly parallel (Processor.swift:57-59's fan-out, multi-device)."""
    from jax.sharding import PartitionSpec as P

    if isinstance(params, (list, tuple)):
        from syllable_detector_tpu.models.neural_net import stack_params
        from syllable_detector_tpu.parallel.mesh import sharded_offline_outputs

        return sharded_offline_outputs(
            mesh, spec, stack_params(list(params)), xs, method=method
        )

    axis = mesh.axis_names[0]

    def local(x):
        return batch_offline_outputs_shared(spec, params, x, method=method)

    fn = jax.shard_map(
        local, mesh=mesh, in_specs=(P(axis),), out_specs=P(axis),
    )
    return jax.jit(fn)(xs)


def scan_corpus(
    cfg: SyllableDetectorConfig,
    streams: Sequence[np.ndarray],
    method: str = "matmul",
    mesh=None,
    lane_configs: Optional[Sequence[SyllableDetectorConfig]] = None,
) -> list[np.ndarray]:
    """Detect over many same-rate streams at once -> per-stream [E_i, outputs].

    Streams are zero-padded to a common bucket and batched; each result is
    trimmed back to the stream's true evaluation count. Zero padding cannot
    create detections by itself, but an eval window straddling the end of a
    short stream sees padded zeros exactly as the reference sees silence.
    With ``mesh``, the lane axis is sharded across the mesh's devices
    (lanes padded to a multiple of the mesh size).

    ``lane_configs`` gives each stream its own DISTINCT network (the
    reference's one-net-per-channel deployment, Processor.swift:57-59) —
    one config per stream, all sharing ``cfg``'s pipeline geometry
    (thresholds may differ; they are applied later per lane).
    """
    spec, params = _spec_cache(cfg)
    if not streams:
        return []
    if lane_configs is not None:
        import dataclasses

        if len(lane_configs) != len(streams):
            raise ValueError(
                f"{len(lane_configs)} lane networks for {len(streams)} streams"
            )
        base = dataclasses.replace(spec, thresholds=())
        plist = []
        for c in lane_configs:
            s_i, p_i = _spec_cache(c)
            if dataclasses.replace(s_i, thresholds=()) != base:
                raise ValueError(
                    "per-lane networks must share the first network's "
                    "geometry (sampling rate, FFT/window, band, layer sizes)"
                )
            plist.append(p_i)
    streams = [np.asarray(s, np.float32).reshape(-1) for s in streams]
    bucket = _bucket(max(len(s) for s in streams))
    lanes = len(streams)
    if mesh is not None:
        n_dev = int(np.prod(list(mesh.shape.values())))
        lanes = -(-lanes // n_dev) * n_dev
    if lane_configs is not None:
        # padding lanes reuse net 0 (their outputs are sliced away)
        params = plist + [plist[0]] * (lanes - len(streams))
    xs = np.zeros((lanes, bucket), np.float32)
    for i, s in enumerate(streams):
        xs[i, : len(s)] = s
    if mesh is not None:
        outs = np.asarray(
            sharded_batch_offline_outputs_shared(
                mesh, spec, params, jnp.asarray(xs), method=method
            )
        )
    else:
        outs = np.asarray(
            batch_offline_outputs_shared(
                spec, params, jnp.asarray(xs), method=method
            )
        )
    results = []
    for i, s in enumerate(streams):
        f = num_frames(len(s), cfg.window_length, cfg.window_overlap)
        e = max(0, f - cfg.time_range + 1)
        results.append(outs[i, :e])
    return results


def corpus_csv_lines(
    cfg: SyllableDetectorConfig,
    outputs: np.ndarray,
    channel: int = 0,
    debounce_frames: int = 0,
) -> list[str]:
    """CSV detection lines from batched outputs, byte-identical accounting to
    the streaming TrackDetector (TrackDetector.swift:45-105)."""
    next_output = cfg.first_output_sample
    hop_inc = cfg.window_length - cfg.window_overlap
    thr = np.asarray(cfg.thresholds, np.float64)
    debounce_until = -1
    lines = []
    for row in outputs:
        cur = next_output
        next_output += hop_inc
        if np.any(row.astype(np.float64) >= thr) and debounce_until < cur:
            line = f"{channel},{cur},{fmt_double(cur / cfg.sampling_rate)}"
            for d in row:
                line += f",{fmt_float32(d)}"
            lines.append(line)
            debounce_until = cur + debounce_frames
    return lines


def scan_corpus_files(
    cfg: SyllableDetectorConfig,
    paths: Sequence[str],
    debounce_seconds: Optional[float] = None,
    emit=print,
    err=None,
    method: str = "matmul",
    headers: Optional[bool] = None,
    mesh=None,
    resample: bool = True,
    group_files: Optional[int] = None,
) -> None:
    """File-level corpus scan with the CLI's multi-file output contract.
    ``headers`` forces (or suppresses) per-file path header lines; None =
    the CLI default, emit them only when scanning more than one file.

    Every channel of every file becomes one lane of the batch (the reference
    CLI runs one TrackDetector per audio track, main.swift:86-90). Within a
    file, detection lines are emitted grouped by channel in channel order —
    identical to sequential mode for files shorter than its chunk size.

    ``group_files`` bounds memory on huge corpora: files are scanned in
    groups of that many (output order and the CSV contract unchanged —
    file-major), so one long file no longer forces every lane to its
    padded bucket length and the whole corpus never sits in RAM at once.

    ``cfg`` may be a sequence of configs: channel c of every file then uses
    network ``cfgs[c % len(cfgs)]`` (cycled, like the GUI's per-row network
    loading, ViewControllerProcessor.swift:222-276). All nets must share the first network's pipeline geometry.
    """
    import sys

    cfgs = list(cfg) if isinstance(cfg, (list, tuple)) else [cfg]
    cfg = cfgs[0]
    err = err if err is not None else (lambda s: print(s, file=sys.stderr))
    if group_files and len(paths) > group_files:
        forced = len(paths) > 1 if headers is None else headers
        for i in range(0, len(paths), group_files):
            scan_corpus_files(
                cfgs if len(cfgs) > 1 else cfg, paths[i : i + group_files],
                debounce_seconds=debounce_seconds, emit=emit, err=err,
                method=method, headers=forced, mesh=mesh, resample=resample,
            )
        return
    streams = []  # one entry per (file, channel) lane
    lanes = []  # (path index, channel)
    good_paths = []
    for p in paths:
        try:
            samples, rate = read_audio(p)
        except (OSError, ValueError) as e:
            err(f"Unable to read {p}: {e}")
            continue
        if rate != cfg.sampling_rate and not resample:
            # match the sequential path's --no-resample contract: warn and
            # process at the network rate (cli.run_file does the same)
            err(
                f"Warning: {p} is {rate} Hz but the network expects "
                f"{cfg.sampling_rate} Hz (resampling disabled)."
            )
        elif rate != cfg.sampling_rate:
            # polyphase-resample to the net rate before detection, like
            # the reference's AVAssetReader output settings
            from syllable_detector_tpu.ops.resample import polyphase_resample

            err(f"Resampling {p} from {rate} Hz to {cfg.sampling_rate} Hz.")
            samples = np.stack(
                [
                    np.asarray(
                        polyphase_resample(
                            np.ascontiguousarray(samples[:, c]),
                            rate,
                            cfg.sampling_rate,
                        )
                    )
                    for c in range(samples.shape[1])
                ],
                axis=1,
            )
        good_paths.append(p)
        for c in range(samples.shape[1]):
            streams.append(np.ascontiguousarray(samples[:, c]))
            lanes.append((len(good_paths) - 1, c))
    if not streams:
        return
    lane_cfgs = (
        [cfgs[c % len(cfgs)] for (_pi, c) in lanes] if len(cfgs) > 1 else None
    )
    results = scan_corpus(
        cfg, streams, method=method, mesh=mesh, lane_configs=lane_cfgs
    )
    debounce = int((debounce_seconds or 0.0) * cfg.sampling_rate)
    multiple = len(good_paths) > 1 if headers is None else headers
    by_file: dict[int, list] = {}
    for (pi, c), outs in zip(lanes, results):
        by_file.setdefault(pi, []).append((c, outs))
    for i, p in enumerate(good_paths):
        if multiple:
            emit(p)
        for c, outs in by_file.get(i, ()):
            # per-lane thresholds: channel c's own network decides its lines
            for line in corpus_csv_lines(
                cfgs[c % len(cfgs)], outs, channel=c, debounce_frames=debounce
            ):
                emit(line)
