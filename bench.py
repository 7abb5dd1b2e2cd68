"""Benchmark of the detection paths on one NVIDIA GPU.

Times the XLA pipeline (models/detector.offline_outputs) at two shapes of
the sample-geometry net (sample_net.txt: 256-point hamming band DFT ->
29 bins x 10-frame sliding features -> l2normalize + mapminmax -> 290x4
TanSig -> 4x1 PureLin -> mapminmax reverse):

  * corpus: 40 streams of 2^22 samples (about 63 min of 44.1 kHz audio),
    one shared net, float32 — the batched ``cli --batched`` shape;
  * colony drain: the live bank's one-program drain for 256 lanes with
    distinct nets, int16 wire, 128-hop bucket.

Each time is the host clock around ``block_until_ready``, warm-up
excluded, median of 7 runs. Outputs are checked against the same program
under ``jax.default_matmul_precision("highest")``.

Prints the card's name and power limit on stderr, then ONE JSON line on
stdout. Exits non-zero without a GPU: it never measures the CPU.

    python bench.py
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import numpy as np

from syllable_detector_tpu.config.model_format import load_config
from syllable_detector_tpu.models.detector import (
    detector_spec_from_config,
    offline_outputs,
)
from syllable_detector_tpu.models.detector_bank import _bank_program
from syllable_detector_tpu.models.neural_net import stack_params
from syllable_detector_tpu.ops.stft import num_frames
from syllable_detector_tpu.utils.compile_cache import enable_compile_cache
from syllable_detector_tpu.utils.synth import perturbed_params

SAMPLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sample_net.txt")
REPS = 7


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def median_seconds(fn, *args):
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main() -> int:
    if jax.default_backend() != "gpu":
        log(f"bench.py needs an NVIDIA GPU; JAX found {jax.devices()}")
        return 1
    enable_compile_cache()
    dev = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"card: {card}")

    cfg = load_config(SAMPLE)
    spec, params = detector_spec_from_config(cfg)
    rng = np.random.default_rng(0)

    # corpus: one shared net over 40 long streams
    lanes, n = 40, 1 << 22
    xs = jax.device_put((0.3 * rng.standard_normal((lanes, n))).astype(np.float32))
    corpus = jax.jit(jax.vmap(lambda x: offline_outputs(spec, params, x)))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(corpus(xs))
    err_corpus = float(np.abs(np.asarray(corpus(xs)) - ref).max())
    t_corpus = median_seconds(corpus, xs)
    evals = lanes * (num_frames(n, spec.window_length, spec.window_overlap)
                     - spec.time_range + 1)
    log(f"corpus: {t_corpus * 1e3:.3f} ms for {evals} windows")

    # colony drain: 256 distinct nets, int16 wire, 128-hop bucket
    lanes = 256
    need = (128 + spec.time_range - 2) * spec.hop + spec.window_length
    codes = jax.device_put(
        rng.integers(-9000, 9000, (lanes, need)).astype(np.int16)
    )
    stacked = stack_params(
        [perturbed_params(params, k) for k in range(lanes)]
    )
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(_bank_program(spec, "int16", stacked, codes))
    err_drain = float(
        np.abs(np.asarray(_bank_program(spec, "int16", stacked, codes)) - ref).max()
    )
    t_drain = median_seconds(
        lambda c: _bank_program(spec, "int16", stacked, c), codes
    )
    log(f"colony drain: {t_drain * 1e3:.3f} ms per round of {lanes} lanes")

    print(json.dumps({
        "metric": "corpus_windows_per_second",
        "value": evals / t_corpus,
        "unit": "windows/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "corpus_ms": t_corpus * 1e3,
        "colony_drain_ms_256_lanes": t_drain * 1e3,
        "parity_max_abs_err": max(err_corpus, err_drain),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
