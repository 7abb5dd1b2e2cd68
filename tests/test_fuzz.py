"""Property tests: random detector geometries through every pipeline path.

Randomized window/overlap(gap)/fft/timeRange/band/scaling/architecture
configs, each validated against the independent NumPy oracle and for
streaming/offline equivalence — the geometry edge cases (gaps, zero padding,
window < fft, multi-output nets) that targeted tests can miss.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import reference_impl as ref
from syllable_detector_tpu.config.model_format import (
    LayerSpec,
    ProcessingSpec,
    SyllableDetectorConfig,
    dumps_config,
    loads_config,
)
from syllable_detector_tpu.models.detector import (
    Detector,
    detector_spec_from_config,
    fusable,
    offline_outputs,
)
from syllable_detector_tpu.ops.stft import frequency_index_range


def random_config(rng: np.random.Generator) -> SyllableDetectorConfig:
    fft = int(rng.choice([64, 128, 256, 512]))
    window = int(rng.choice([fft, fft, fft // 2, max(16, fft - 24)]))
    window = min(window, fft)
    kind = rng.choice(["overlap", "zero", "gap"])
    if kind == "overlap":
        overlap = int(rng.integers(1, window))
    elif kind == "zero":
        overlap = 0
    else:
        overlap = -int(rng.integers(1, window))
    rate = float(rng.choice([8000.0, 22050.0, 44100.0]))
    f_hi_max = rate / 2 * 0.9
    f0 = float(rng.uniform(0, f_hi_max / 2))
    f1 = float(rng.uniform(f0 + f_hi_max / 8, f_hi_max))
    bins = frequency_index_range(fft, f0, f1, rate)
    if bins is None or bins[1] - bins[0] < 1:
        f0, f1 = 0.0, f_hi_max
        bins = frequency_index_range(fft, f0, f1, rate)
    t_range = int(rng.integers(1, 8))
    n_bins = bins[1] - bins[0]
    d = n_bins * t_range
    scaling = str(rng.choice(["linear", "linear", "db", "log"]))

    hidden = int(rng.integers(1, 6))
    outputs = int(rng.integers(1, 3))
    layers = [
        LayerSpec(
            inputs=d,
            outputs=hidden,
            weights=rng.standard_normal((hidden, d)).astype(np.float32) * 0.3,
            biases=rng.standard_normal(hidden).astype(np.float32) * 0.1,
            transfer=str(rng.choice(["TanSig", "LogSig", "SatLin"])),
        ),
        LayerSpec(
            inputs=hidden,
            outputs=outputs,
            weights=rng.standard_normal((outputs, hidden)).astype(np.float32),
            biases=rng.standard_normal(outputs).astype(np.float32) * 0.1,
            transfer=str(rng.choice(["PureLin", "TanSig"])),
        ),
    ]
    process_inputs = [ProcessingSpec("l2normalize")]
    if rng.random() < 0.7:
        process_inputs.append(
            ProcessingSpec(
                "mapminmax",
                x_offsets=rng.random(d).astype(np.float32) * 1e-3,
                gains=(rng.random(d) + 0.5).astype(np.float32) * 4,
                y_offset=-1.0,
            )
        )
    process_outputs = []
    if rng.random() < 0.7:
        process_outputs.append(
            ProcessingSpec(
                "mapminmax",
                x_offsets=np.zeros(outputs, np.float32),
                gains=np.full(outputs, 2.0, np.float32),
                y_offset=-1.0,
            )
        )
    return SyllableDetectorConfig(
        sampling_rate=rate,
        fourier_length=fft,
        window_length=window,
        window_overlap=overlap,
        freq_range=(f0, f1),
        time_range=t_range,
        thresholds=[0.5] * outputs,
        scaling=scaling,
        layers=layers,
        process_inputs=process_inputs,
        process_outputs=process_outputs,
    )


@pytest.mark.parametrize("seed", range(12))
def test_random_config_pipeline(seed):
    rng = np.random.default_rng(1000 + seed)
    cfg = random_config(rng)
    spec, params = detector_spec_from_config(cfg)

    n = int(rng.integers(4 * (cfg.gap + cfg.window_length), 30000))
    x = (rng.standard_normal(n) * 0.3 + 0.05).astype(np.float32)
    # db scaling needs nonzero magnitudes everywhere: add a floor tone
    t = np.arange(n)
    x += 0.05 * np.sin(2 * np.pi * 0.1 * t).astype(np.float32)

    got = np.asarray(offline_outputs(spec, params, jnp.asarray(x)))
    want = ref.detect_offline(cfg, x)
    assert got.shape == want.shape
    if len(want):
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-3)

    # text-format round trip preserves behavior
    cfg2 = loads_config(dumps_config(cfg))
    spec2, params2 = detector_spec_from_config(cfg2)
    got2 = np.asarray(offline_outputs(spec2, params2, jnp.asarray(x)))
    np.testing.assert_allclose(got2, got, rtol=1e-6, atol=1e-7)

    # host streaming detector equals offline at odd chunkings
    det = Detector(cfg)
    outs = []
    pos = 0
    while pos < n:
        c = int(rng.integers(50, 5000))
        det.append_audio_data(x[pos : pos + c])
        o = det.drain()
        if len(o):
            outs.append(o)
        pos += c
    stream = (
        np.concatenate(outs) if outs else np.zeros((0, got.shape[1]), np.float32)
    )
    assert stream.shape == got.shape
    if len(got):
        np.testing.assert_allclose(stream, got, rtol=5e-3, atol=1e-3)

    # sequence-parallel (time-sharded, ppermute halo) equals offline for
    # every random geometry — gaps, odd lengths, short-stream fallback
    from syllable_detector_tpu.parallel.mesh import (
        make_mesh,
        tensor_sharded_offline_outputs,
        time_sharded_offline_outputs,
    )

    mesh_t = make_mesh(4, axis="time")
    sp = np.asarray(time_sharded_offline_outputs(mesh_t, spec, params, jnp.asarray(x)))
    assert sp.shape == got.shape
    if len(got):
        np.testing.assert_allclose(sp, got, rtol=5e-3, atol=1e-3)

    # tensor-parallel (bin-sharded, one psum) where the pattern allows
    if fusable(spec) and len(got):
        mesh_m = make_mesh(4, axis="model")
        tp = np.asarray(
            tensor_sharded_offline_outputs(mesh_m, spec, params, jnp.asarray(x))
        )
        assert tp.shape == got.shape
        np.testing.assert_allclose(tp, got, rtol=5e-3, atol=1e-3)

    # per-channel DISTINCT nets on the batched corpus path for every random
    # geometry: each lane must equal its own net's single-stream outputs
    if len(got):
        from syllable_detector_tpu.corpus import batch_offline_outputs_shared
        from syllable_detector_tpu.utils.synth import perturbed_params

        plist = [params, perturbed_params(params, seed),
                 perturbed_params(params, seed + 99)]
        xs = jnp.stack([jnp.asarray(x)] * 3)
        fb = np.asarray(batch_offline_outputs_shared(spec, plist, xs))
        for lane, p in enumerate(plist):
            np.testing.assert_allclose(
                fb[lane],
                np.asarray(offline_outputs(spec, p, jnp.asarray(x))),
                rtol=1e-5, atol=1e-6,
            )

    # DetectorBank (batched live drain) equals independent Detectors for
    # every random geometry
    if len(got):
        from syllable_detector_tpu.models.detector_bank import DetectorBank

        bank = DetectorBank([cfg, cfg])
        det_b = Detector(cfg)
        bank_outs, det_outs = [], []
        pos = 0
        while pos < n:
            c = int(rng.integers(400, 6000))
            bank.append_audio_data(0, x[pos : pos + c])
            bank.append_audio_data(1, x[pos : pos + c])
            det_b.append_audio_data(x[pos : pos + c])
            bo = bank.drain()
            if bo.shape[1]:
                bank_outs.append(bo[0])
            do = det_b.drain()
            if len(do):
                det_outs.append(do)
            pos += c
        bank_cat = (
            np.concatenate(bank_outs)
            if bank_outs
            else np.zeros((0, got.shape[1]), np.float32)
        )
        det_cat = (
            np.concatenate(det_outs)
            if det_outs
            else np.zeros((0, got.shape[1]), np.float32)
        )
        assert bank_cat.shape == det_cat.shape
        if len(det_cat):
            np.testing.assert_allclose(
                bank_cat, det_cat, rtol=5e-3, atol=1e-3
            )
