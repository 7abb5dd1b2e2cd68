"""Regenerate ``sample_net.txt``, the checked-in sample-geometry net.

Trains the reference's example geometry (44.1 kHz, FFT/window 256,
overlap 124, 2-7 kHz band = 29 bins, timeRange 10: a 290 -> 4 TanSig ->
1 PureLin net with l2normalize + mapminmax) on 20 s of
``utils/synth.py`` chirp audio from seed 0, through the ``train`` CLI at
its defaults. The net fires on 2-7 kHz chirps and stays silent on noise.

    JAX_PLATFORMS=cpu python scripts/make_sample_net.py [-o sample_net.txt]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from syllable_detector_tpu.train import main as train_main
from syllable_detector_tpu.utils.synth import make_labeled_audio
from syllable_detector_tpu.utils.wav import write_wav


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("-o", "--output", default="sample_net.txt")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    x, intervals = make_labeled_audio(seconds=20.0, seed=args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "train.wav")
        labels = os.path.join(tmp, "labels.csv")
        write_wav(wav, x, 44100, dtype="float32")
        with open(labels, "w") as fh:
            fh.writelines(f"{a},{b}\n" for a, b in intervals)
        return train_main(
            ["-a", wav, "-l", labels, "-o", args.output,
             "--seed", str(args.seed), "--quiet"]
        )


if __name__ == "__main__":
    sys.exit(main())
