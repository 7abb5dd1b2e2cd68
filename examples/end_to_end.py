"""End-to-end example: synthesize labeled audio, train a detector, export it,
detect with the CLI path, render a simulator WAV, and run the live pipeline.

Run:  python examples/end_to_end.py [workdir] [--device]

Runs on the host CPU by default; pass --device to use JAX's default
accelerator (an NVIDIA GPU).
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--device" in sys.argv:
    sys.argv.remove("--device")
else:
    import jax

    jax.config.update("jax_platforms", "cpu")

from syllable_detector_tpu.cli import main as cli_main
from syllable_detector_tpu.config import load_config, save_config
from syllable_detector_tpu.sim import main as sim_main
from syllable_detector_tpu.training import (
    TrainSettings,
    export_trained_config,
    features_and_labels,
    train,
)
from syllable_detector_tpu.utils.wav import write_wav


def make_labeled_audio(seconds=4.0, rate=44100, seed=0):
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    x = 0.01 * rng.standard_normal(n)
    intervals = []
    pos = 0.3
    while pos + 0.25 < seconds:
        lo, hi = pos, pos + 0.15
        m = (t >= lo) & (t < hi)
        tt = t[m] - lo
        f0 = 3000.0 + 1500.0 * np.sin(2 * np.pi * 8 * tt)
        x[m] += 0.6 * np.sin(2 * np.pi * np.cumsum(f0) / rate)
        intervals.append((lo + 0.02, hi - 0.01))
        pos += 0.55
    return x.astype(np.float32), intervals


def main():
    workdir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/syldet_example"
    os.makedirs(workdir, exist_ok=True)
    wav = os.path.join(workdir, "song.wav")
    net = os.path.join(workdir, "net.txt")
    detsig = os.path.join(workdir, "detections.wav")

    print("== synthesizing labeled audio ==")
    audio, intervals = make_labeled_audio()
    write_wav(wav, audio, 44100, dtype="float32")
    print(f"{len(audio)/44100:.1f}s with {len(intervals)} syllables -> {wav}")

    print("== training ==")
    settings = TrainSettings(epochs=250, batch_size=256, learning_rate=3e-3, seed=1)
    feats, labels = features_and_labels(settings, audio, intervals)
    net_spec, params, threshold = train(settings, feats, labels)
    save_config(export_trained_config(settings, net_spec, params, threshold), net)
    print(f"threshold {threshold:.4f} -> {net}")

    print("== CLI detection (channel,sample,seconds,output) ==")
    cli_main(["-n", net, "-a", wav])

    print("== simulator (detection-signal WAV) ==")
    sim_main(["-n", net, "-a", wav, "-o", detsig])
    print(f"-> {detsig}")

    print("== live pipeline (simulated device, audio TTL) ==")
    from syllable_detector_tpu.monitor import main as monitor_main

    monitor_main(["-n", net, "-a", wav, "--channels", "2", "--duration", "2"])

    print("== per-channel DISTINCT nets: batched corpus + batched live drain ==")
    # a second net of the same geometry (a sibling trained from another
    # seed) cycled onto channel 1, all lanes evaluated in ONE device program
    net2 = os.path.join(workdir, "net2.txt")
    settings2 = TrainSettings(epochs=250, batch_size=256, learning_rate=3e-3, seed=7)
    feats2, labels2 = features_and_labels(settings2, audio, intervals)
    net_spec2, params2, threshold2 = train(settings2, feats2, labels2)
    save_config(
        export_trained_config(settings2, net_spec2, params2, threshold2), net2
    )
    stereo = os.path.join(workdir, "stereo.wav")
    write_wav(stereo, np.stack([audio, audio], axis=1), 44100, dtype="float32")
    cli_main(["-n", net, "-n", net2, "-a", stereo, "--batched"])
    monitor_main(
        ["-n", net, "-n", net2, "-a", wav, "--channels", "2",
         "--duration", "2", "--batched-drain"]
    )


if __name__ == "__main__":
    main()
