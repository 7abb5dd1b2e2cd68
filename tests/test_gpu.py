"""Card-only checks (marker ``gpu``): the XLA paths on an NVIDIA GPU agree
with the float64 NumPy oracle to the output contract (1e-4 absolute; a
float32 matmul that slipped to TF32 misses it by ~100x, because the folded
mapminmax gains amplify operand rounding). Skipped without a GPU;
``chip_smoke.py`` runs them on the card."""

import numpy as np
import pytest

import reference_impl as ref
from syllable_detector_tpu.models.detector import (
    detector_spec_from_config,
    offline_outputs,
)
from syllable_detector_tpu.models.detector_bank import DetectorBank
from test_detector import make_audio

TOL = 1e-4  # outputs lie in [0, 1]


@pytest.mark.gpu
def test_offline_outputs_on_gpu_match_oracle(gpu, sample_config):
    x = make_audio(np.random.default_rng(0), seconds=2.0)
    spec, params = detector_spec_from_config(sample_config)
    got = np.asarray(offline_outputs(spec, params, x))
    want = ref.detect_offline(sample_config, x)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("wire", ["float32", "int16"])
def test_bank_drain_on_gpu_matches_oracle(gpu, sample_config, wire):
    rng = np.random.default_rng(1)
    streams = [make_audio(rng, seconds=1.0) for _ in range(4)]
    if wire == "int16":  # audio already on the int16 grid: exact wire
        streams = [np.rint(s * 32767) / np.float32(32767) for s in streams]
    bank = DetectorBank([sample_config] * 4, transfer_dtype=wire)
    for i, s in enumerate(streams):
        bank.append_audio_data(i, s)
    outs = bank.drain(flush=True)
    for i, s in enumerate(streams):
        want = ref.detect_offline(sample_config, s.astype(np.float32))
        got = outs[i, : bank.last_counts[i]]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= TOL
