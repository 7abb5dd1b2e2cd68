"""syllable_detector_tpu — a real-time syllable detection framework.

A ground-up JAX/XLA re-design of the capabilities of
gardner-lab/syllable-detector-swift:
low-latency streaming short-time Fourier transform + small feed-forward
neural network detection over live or recorded audio, scaled from a single
channel to hundreds of concurrent detector lanes per device program, sharded
over a device mesh.

Layer map (mirrors the reference's six layers, re-architected for batching):

  L6  entry points .......... syllable_detector_tpu.cli / .sim / .monitor
  L5  orchestration ......... syllable_detector_tpu.runtime (processor, track_detector)
  L4  device I/O ............ syllable_detector_tpu.runtime (audio_io, arduino, outputs)
  L3  detection core ........ syllable_detector_tpu.models (neural_net, detector)
  L2  signal primitives ..... syllable_detector_tpu.ops (+ native/ ring)
  L1  config/model format ... syllable_detector_tpu.config

The compute path is pure JAX (jit/vmap/shard_map); the
runtime around it (ring buffers, hop batching) is native C++ with ctypes
bindings, mirroring the reference's TPCircularBuffer C core.
"""

__version__ = "0.1.0"

from syllable_detector_tpu.config import SyllableDetectorConfig, load_config, save_config

__all__ = [
    "SyllableDetectorConfig",
    "load_config",
    "save_config",
    "__version__",
]
