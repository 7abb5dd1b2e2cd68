"""Simulator: detection-signal WAV layout (ViewControllerSimulator parity)."""

from conftest import SAMPLE_TXT
import numpy as np

from syllable_detector_tpu.models.detector import detector_spec_from_config, offline_outputs
from syllable_detector_tpu.sim import main as sim_main, simulate
from syllable_detector_tpu.utils.wav import read_wav, write_wav
from test_detector import make_audio

import jax.numpy as jnp


def test_simulate_layout(sample_config, rng):
    x = make_audio(rng, seconds=0.5)
    signal = simulate(sample_config, x)
    assert signal.shape == x.shape

    first = sample_config.first_output_sample  # 1444
    hop = sample_config.hop
    assert np.all(signal[:first] == 0.0)

    spec, params = detector_spec_from_config(sample_config)
    outs = np.asarray(offline_outputs(spec, params, jnp.asarray(x)))
    want = np.clip(outs[:, 0] / np.float32(sample_config.thresholds[0]), 0, 1)
    for e in (0, 1, len(outs) - 1):
        lo = first + e * hop
        if lo + hop <= len(x):
            region = signal[lo : lo + hop]
            np.testing.assert_allclose(region, want[e], rtol=1e-4, atol=1e-5)


def test_sim_cli(sample_config, rng, tmp_path, capsys):
    x = make_audio(rng, seconds=0.4)
    wav_in = tmp_path / "in.wav"
    wav_out = tmp_path / "out.wav"
    write_wav(wav_in, x, 44100, dtype="float32")
    rc = sim_main(
        ["-n", SAMPLE_TXT, "-a", str(wav_in), "-o", str(wav_out)]
    )
    assert rc == 0
    y, rate = read_wav(wav_out)
    assert rate == 44100 and len(y) == len(x)
    assert np.all(y[:1444] == 0)
    assert y.max() > 0.5  # the chirp triggers
    out = capsys.readouterr().out
    assert "ingest" in out and "process" in out  # latency stats printed


def test_sim_cli_errors(tmp_path, capsys):
    assert sim_main(["-n", str(tmp_path / "x.txt"), "-a", "a.wav", "-o", "b.wav"]) == 1
    assert (
        sim_main(
            ["-n", SAMPLE_TXT, "-a", str(tmp_path / "no.wav"),
             "-o", str(tmp_path / "b.wav")]
        )
        == 1
    )
