"""L3 — detection core: the MLP and the detector pipelines."""

from syllable_detector_tpu.models.neural_net import (
    NetSpec,
    net_from_config,
    apply_net,
    stack_params,
)
from syllable_detector_tpu.models.detector import (
    Detector,
    DetectorSpec,
    detect_features,
    offline_outputs,
    streaming_init,
    streaming_step,
    streaming_scan,
)

__all__ = [
    "NetSpec",
    "net_from_config",
    "apply_net",
    "stack_params",
    "Detector",
    "DetectorSpec",
    "detect_features",
    "offline_outputs",
    "streaming_init",
    "streaming_step",
    "streaming_scan",
]
