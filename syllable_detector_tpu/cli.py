"""Offline detection CLI — the fidelity oracle.

Re-implements the reference CLI contract
(reference: SyllableDetectorCLI/main.swift:19-131): load one network config,
run each audio file's tracks through per-track detectors, and write a
comma-separated detection event per line to stdout:

    0,1593298,36.1292063492063,0.918557

Columns: track/channel number (from 0), sample number, timestamp in seconds,
then one column per network output (main.swift:31-40). When multiple audio
files are given, each file's path is printed before its events
(main.swift:122-124). Errors go to stderr and processing continues with the
next file (main.swift:57, 74, 81).

Usage:  python -m syllable_detector_tpu.cli -n NET.txt -a FILE.wav [-a ...]
                                            [-d SECONDS]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from syllable_detector_tpu.config.model_format import ConfigError, load_config
from syllable_detector_tpu.runtime.track_detector import TrackDetector
from syllable_detector_tpu.utils.compile_cache import enable_compile_cache
from syllable_detector_tpu.utils.wav import read_audio

__all__ = ["main", "run_file"]

# samples per simulated decode buffer; the reference receives ~8k-sample
# CMSampleBuffers from AVFoundation (SURVEY: main.swift:126-130) — output is
# chunk-size invariant, so a larger batch is used for device efficiency
CHUNK = 65536


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="syllable-detector",
        description="Syllable detection over audio files.",
        epilog=(
            "The command line will write a comma-separated list of detection "
            "events (when the network has at least one output above "
            "threshold) to standard out. Columns: 1. track/channel number "
            "(starting with 0); 2. sample number of the detection; 3. "
            "timestamp of the detection; 4+. the neural network outputs."
        ),
    )
    p.add_argument(
        "-n",
        "--net",
        action="append",
        required=True,
        help="Path to trained network file; repeat to give each audio "
        "channel its own network (cycled per channel, like the GUI's "
        "per-row loading; all nets must share the first net's geometry).",
    )
    p.add_argument(
        "-a",
        "--audio",
        action="append",
        default=[],
        help="Path to the audio file to process (repeatable).",
    )
    p.add_argument(
        "-d",
        "--debounce",
        type=float,
        default=None,
        help="Number of seconds to debounce triggers.",
    )
    p.add_argument(
        "--method",
        choices=("matmul", "rfft"),
        default="matmul",
        help="Spectral backend of the XLA path (default: GEMM band DFT; "
        "'rfft' = full FFT then band slice).",
    )
    p.add_argument(
        "--batched",
        action="store_true",
        help="Batched corpus mode: all files in one device computation.",
    )
    p.add_argument(
        "--batch-files",
        type=int,
        default=None,
        metavar="N",
        help="With --batched: scan the corpus in groups of N files "
        "(bounds memory on huge corpora; output order unchanged).",
    )
    p.add_argument(
        "--mesh",
        action="store_true",
        help="Batched mode only: shard the file/channel lanes across all "
        "local devices (jax.sharding.Mesh).",
    )
    p.add_argument(
        "--no-resample",
        action="store_true",
        help="Do not resample rate-mismatched files to the network rate.",
    )
    return p


def run_file(
    audio_path: str,
    config,
    debounce: float | None,
    emit=print,
    err=None,
    method: str = "matmul",
    resample: bool = True,
) -> bool:
    """Sequential per-file scan. ``config`` may be a sequence of configs:
    channel c uses ``configs[c % len(configs)]`` (the first net's rate
    drives any resampling)."""
    configs = list(config) if isinstance(config, (list, tuple)) else [config]
    config = configs[0]
    err = err if err is not None else (lambda s: print(s, file=sys.stderr))
    try:
        samples, rate = read_audio(audio_path)
    except (OSError, ValueError) as e:
        err(f"Unable to read {audio_path}: {e}")
        return False

    n, channels = samples.shape
    if channels < 1 or n == 0:
        err(f"No audio tracks found in {audio_path}.")
        return False

    if rate != config.sampling_rate and resample:
        # the reference's AVAssetReader resamples decoded audio to the net
        # rate via its output settings (SyllableDetector.swift:19-23); here
        # the polyphase kernel does the equivalent conversion
        from syllable_detector_tpu.ops.resample import polyphase_resample

        err(
            f"Resampling {audio_path} from {rate} Hz to the network rate "
            f"{config.sampling_rate} Hz."
        )
        samples = np.stack(
            [
                np.asarray(
                    polyphase_resample(
                        np.ascontiguousarray(samples[:, c]),
                        rate,
                        config.sampling_rate,
                    )
                )
                for c in range(samples.shape[1])
            ],
            axis=1,
        )
        n = samples.shape[0]
    elif rate != config.sampling_rate:
        err(
            f"Warning: {audio_path} sample rate {rate} != network rate "
            f"{config.sampling_rate}; processing at the network rate."
        )

    detectors = [
        TrackDetector(configs[i % len(configs)], channel=i, emit=emit, method=method)
        for i in range(channels)
    ]
    if debounce is not None:
        for d in detectors:
            d.debounce_time = debounce

    # synchronous read loop over fixed-size buffers (main.swift:126-130)
    for start in range(0, n, CHUNK):
        chunk = samples[start : start + CHUNK]
        for i, det in enumerate(detectors):
            det.process(np.ascontiguousarray(chunk[:, i]))
    return True


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    enable_compile_cache()

    try:
        configs = [load_config(n) for n in args.net]
    except ConfigError as e:
        print(f"Unable to load the network configuration: {e}", file=sys.stderr)
        return 1
    config = configs if len(configs) > 1 else configs[0]

    if len(configs) > 1:
        # all nets must share the first net's geometry — the sequential path
        # would otherwise silently run a wrong-rate net per channel, and the
        # batched path would raise mid-scan; fail fast with a clean message
        import dataclasses

        from syllable_detector_tpu.models.detector import (
            detector_spec_from_config,
        )

        try:
            base = dataclasses.replace(
                detector_spec_from_config(configs[0])[0], thresholds=()
            )
            for path, c in zip(args.net[1:], configs[1:]):
                spec_i = dataclasses.replace(
                    detector_spec_from_config(c)[0], thresholds=()
                )
                if spec_i != base:
                    print(
                        f"Network {path} does not share the first network's "
                        f"geometry (sampling rate, FFT/window, band, layer "
                        f"sizes).",
                        file=sys.stderr,
                    )
                    return 1
        except ValueError as e:
            print(f"Invalid network configuration: {e}", file=sys.stderr)
            return 1

    if args.batched:
        from syllable_detector_tpu.corpus import scan_corpus_files

        mesh = None
        if args.mesh:
            from syllable_detector_tpu.parallel.mesh import make_mesh

            mesh = make_mesh()
        scan_corpus_files(
            config,
            args.audio,
            debounce_seconds=args.debounce,
            method=args.method,
            mesh=mesh,
            resample=not args.no_resample,
            group_files=args.batch_files,
        )
        return 0

    multiple = len(args.audio) > 1
    for audio_path in args.audio:
        if multiple:
            print(audio_path)
        run_file(
            audio_path,
            config,
            args.debounce,
            method=args.method,
            resample=not args.no_resample,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
