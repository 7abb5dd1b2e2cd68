"""Offline simulator: audio file in -> detection-signal WAV out.

Re-implements the reference's de-facto validation harness
(reference: SyllableDetector/ViewControllerSimulator.swift:135-377): stream a
file through one detector and write a mono WAV whose value over each hop
region is clamp(out0 / threshold0, 0, 1) (ViewControllerSimulator.swift:322-337),
with the initial ``window + hop*(timeRange-1)`` samples zero-filled
(ViewControllerSimulator.swift:251-254) — the region before the first network
evaluation exists. Per-hop ingest/process latencies are recorded through
:class:`Time` like the reference (ViewControllerSimulator.swift:291-318) and
printed at the end (ViewControllerSimulator.swift:32).

Usage: python -m syllable_detector_tpu.sim -n NET.txt -a IN.wav -o OUT.wav
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from syllable_detector_tpu.config.model_format import ConfigError, load_config
from syllable_detector_tpu.models.detector import Detector
from syllable_detector_tpu.utils.timing import Time
from syllable_detector_tpu.utils.wav import read_audio, write_wav
from syllable_detector_tpu.utils.compile_cache import enable_compile_cache

__all__ = ["simulate", "main"]


def simulate(
    config, samples: np.ndarray, chunk: int = 8192, method: str = "matmul"
) -> np.ndarray:
    """Run the detector over ``samples`` and render the detection signal.

    Output has the same length as the input: zeros for the initial
    pre-first-decision region, then hop-length runs of
    clamp(out0/threshold0, 0, 1), zero beyond the final full hop region.
    """
    samples = np.asarray(samples, np.float32).reshape(-1)
    n = len(samples)
    det = Detector(config, method=method)
    threshold0 = np.float32(config.thresholds[0])
    hop = config.window_length - config.window_overlap  # region length per eval
    first = config.first_output_sample

    signal = np.zeros(n, np.float32)
    outputs = []
    for start in range(0, n, chunk):
        Time.start_with_name("ingest")
        det.append_audio_data(samples[start : start + chunk])
        Time.stop_and_save_with_name("ingest")
        Time.start_with_name("process")
        outs = det.drain()
        elapsed = Time.stop_and_save_with_name("process")
        if len(outs) == 0:
            Time.save_with_name("skip", elapsed)
        outputs.append(outs)

    outs = (
        np.concatenate(outputs) if outputs else np.zeros((0, 1), np.float32)
    )
    v = np.clip(outs[:, 0] / threshold0, 0.0, 1.0)
    for e, value in enumerate(v):
        lo = first + e * hop
        if lo >= n:
            break
        signal[lo : min(lo + hop, n)] = value
    return signal


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="syllable-detector-sim",
        description=(
            "Simulate a detector over an audio file and write the detection "
            "signal as a WAV (value per hop = clamp(output/threshold, 0, 1))."
        ),
    )
    p.add_argument("-n", "--net", required=True, help="Path to trained network file.")
    p.add_argument("-a", "--audio", required=True, help="Input audio file.")
    p.add_argument("-o", "--output", required=True, help="Output WAV path.")
    p.add_argument("--channel", type=int, default=0, help="Input channel to use.")
    p.add_argument("--method", choices=("matmul", "rfft"), default="matmul")
    args = p.parse_args(argv)
    enable_compile_cache()

    try:
        config = load_config(args.net)
    except ConfigError as e:
        print(f"Unable to load the network configuration: {e}", file=sys.stderr)
        return 1

    try:
        samples, rate = read_audio(args.audio)
    except (OSError, ValueError) as e:
        print(f"Unable to read {args.audio}: {e}", file=sys.stderr)
        return 1

    if args.channel >= samples.shape[1]:
        print(f"No channel {args.channel} in {args.audio}.", file=sys.stderr)
        return 1

    signal = simulate(config, samples[:, args.channel], method=args.method)
    # 16-bit mono at the detector rate (ViewControllerSimulator.swift:197-226)
    write_wav(args.output, signal, int(config.sampling_rate), dtype="int16")
    Time.print_all()
    return 0


if __name__ == "__main__":
    sys.exit(main())
