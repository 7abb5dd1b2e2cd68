"""Detector training — the JAX replacement for the MATLAB workflow.

The reference trains its MLP offline in MATLAB and exports it to the text
format with convert_to_text.m (reference: convert_to_text.m:1-214). Here the
same subset of networks (strictly-chained MLP with mapminmax/l2normalize
processing) trains natively in JAX/optax from labeled audio, data-parallel
over a mesh, and exports to the identical text format — loadable by this
framework's CLI *and* by the reference Swift app.
"""

from syllable_detector_tpu.training.checkpoint import (
    save_checkpoint,
    restore_checkpoint,
    latest_step,
)
from syllable_detector_tpu.training.trainer import (
    TrainSettings,
    features_and_labels,
    fit_mapminmax,
    init_layer_params,
    train,
    train_ensemble,
    train_step,
    make_ensemble_epoch,
    export_trained_config,
)

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "TrainSettings",
    "features_and_labels",
    "fit_mapminmax",
    "init_layer_params",
    "train",
    "train_ensemble",
    "train_step",
    "make_ensemble_epoch",
    "export_trained_config",
]
