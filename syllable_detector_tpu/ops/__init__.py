"""L2 — signal-processing primitives as pure JAX functions.

Batched re-design of the reference's streaming vDSP pipeline
(Common/CircularShortTimeFourierTransform.swift, Common/NeuralNet.swift's
processing/transfer functions, Common/Resampler.swift): everything here is a
pure function over fixed-shape arrays so it jits, vmaps, and shards cleanly.
"""

from syllable_detector_tpu.ops.windows import make_window, WINDOW_TYPES
from syllable_detector_tpu.ops.stft import (
    frequency_index_range,
    frequencies_for_sample_rate,
    num_frames,
    frame_signal,
    spectral_frames,
    band_dft_matrices,
    stack_features,
)
from syllable_detector_tpu.ops.processing import (
    apply_input_chain,
    reverse_output_chain,
)
from syllable_detector_tpu.ops.transfer import apply_transfer
from syllable_detector_tpu.ops.scaling import apply_scaling
from syllable_detector_tpu.ops.resample import (
    LinearResamplerState,
    linear_resample_init,
    linear_resample_chunk,
    linear_resample_chunk_exact,
    linear_resample,
    polyphase_resample,
)

__all__ = [
    "make_window",
    "WINDOW_TYPES",
    "frequency_index_range",
    "frequencies_for_sample_rate",
    "num_frames",
    "frame_signal",
    "spectral_frames",
    "band_dft_matrices",
    "stack_features",
    "apply_input_chain",
    "reverse_output_chain",
    "apply_transfer",
    "apply_scaling",
    "LinearResamplerState",
    "linear_resample_init",
    "linear_resample_chunk",
    "linear_resample_chunk_exact",
    "linear_resample",
    "polyphase_resample",
]
