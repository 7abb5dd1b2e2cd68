"""GPU smoke: native training on the card.

Validates the training subsystem end-to-end on hardware: single-net
training with n_init vmapped restarts, the channel-stacked ensemble
(train_ensemble), and the epoch-as-one-device-program contract (one
dispatch per epoch, not one per optimizer step). Both trained nets must separate their
channel's syllables, and the exported text nets must reload and detect.

Run:  python scripts/train_hw.py
"""

import os
import sys
import time


sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from syllable_detector_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import jax
import numpy as np

from syllable_detector_tpu.utils.synth import make_labeled_audio


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    from syllable_detector_tpu.config.model_format import (
        dumps_config,
        first_output_sample,
        loads_config,
    )
    from syllable_detector_tpu.models.detector import Detector
    from syllable_detector_tpu.models.neural_net import apply_net
    from syllable_detector_tpu.training.trainer import (
        TrainSettings,
        export_trained_config,
        features_and_labels,
        train,
        train_ensemble,
    )

    dev = jax.devices()[0]
    log(f"device: {dev} platform={dev.platform}")

    settings = TrainSettings(
        epochs=150, batch_size=256, hidden=(4,), learning_rate=3e-3, seed=1
    )
    feats, labels, audios, ivals = [], [], [], []
    for seed in (3, 9):
        audio, intervals = make_labeled_audio(seed=seed)
        f, l = features_and_labels(settings, audio, intervals)
        feats.append(f)
        labels.append(l)
        audios.append(audio)
        ivals.append(intervals)

    # --- single net, vmapped restarts ---
    t0 = time.perf_counter()
    net_spec, params, threshold = train(settings, feats[0], labels[0])
    t1 = time.perf_counter()
    log(f"train() {settings.epochs} epochs x {settings.n_init} inits: "
        f"{t1-t0:.1f} s ({(t1-t0)/settings.epochs*1e3:.0f} ms/epoch "
        f"incl. compile)")
    preds = np.asarray(apply_net(net_spec, params, feats[0])[..., 0])
    sep = preds[labels[0] > 0.5].mean() - preds[labels[0] < 0.5].mean()
    log(f"single-net separation: {sep:.3f} threshold {threshold:.3f}")
    assert sep > 0.3, sep

    # --- channel-stacked ensemble (2 distinct nets, one program) ---
    t0 = time.perf_counter()
    net_spec, params_list, thresholds = train_ensemble(
        settings, feats, labels
    )
    t1 = time.perf_counter()
    log(f"train_ensemble(C=2) {settings.epochs} epochs x "
        f"{settings.n_init} inits: {t1-t0:.1f} s "
        f"({(t1-t0)/settings.epochs*1e3:.0f} ms/epoch incl. compile)")
    for c in range(2):
        preds = np.asarray(
            apply_net(net_spec, params_list[c], feats[c])[..., 0]
        )
        sep = preds[labels[c] > 0.5].mean() - preds[labels[c] < 0.5].mean()
        log(f"ensemble ch{c}: separation {sep:.3f} "
            f"threshold {thresholds[c]:.3f}")
        assert sep > 0.3, (c, sep)

    # --- export -> reload -> detect on the card ---
    for c in range(2):
        cfg = loads_config(
            dumps_config(
                export_trained_config(
                    settings, net_spec, params_list[c], thresholds[c]
                )
            )
        )
        det = Detector(cfg)
        det.append_audio_data(audios[c])
        outs = det.drain()
        hop = settings.window_length - settings.window_overlap
        first = first_output_sample(
            settings.window_length,
            settings.window_overlap,
            settings.time_range,
        )
        t = (first + hop * np.arange(len(outs))) / settings.sampling_rate
        fired = outs[:, 0] >= np.float32(cfg.thresholds[0])
        inside = np.zeros(len(outs), bool)
        near = np.zeros(len(outs), bool)
        for lo, hi in ivals[c]:
            inside |= (t >= lo) & (t <= hi)
            near |= (t >= lo - 0.1) & (t <= hi + 0.1)
        recall = fired[inside].mean()
        false_rate = fired[~near].mean()
        log(f"detect ch{c}: recall {recall:.2f} false rate {false_rate:.3f}")
        assert recall > 0.6 and false_rate < 0.05, (c, recall, false_rate)

    print("OK")


if __name__ == "__main__":
    main()
