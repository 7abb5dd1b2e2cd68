"""Detector pipeline: offline vs NumPy oracle, streaming equivalence,
chunk-size invariance, net forward pass."""

import jax.numpy as jnp
import numpy as np
import pytest

import reference_impl as ref
from syllable_detector_tpu.models.detector import (
    Detector,
    detector_spec_from_config,
    offline_outputs,
    streaming_init,
    streaming_step,
)
from syllable_detector_tpu.models.neural_net import apply_net, net_from_config


def make_audio(rng, seconds=1.0, rate=44100):
    """Noise + a chirp sweeping the detector band; triggers the sample net."""
    n = int(seconds * rate)
    t = np.arange(n) / rate
    phase = 2 * np.pi * np.cumsum(np.linspace(2000.0, 7000.0, n)) / rate
    x = 0.5 * np.sin(phase) + 0.02 * rng.standard_normal(n)
    # amplitude bursts so outputs move around
    env = 0.3 + 0.7 * (np.sin(2 * np.pi * 3.0 * t) > 0)
    return (x * env).astype(np.float32)


def test_net_apply_matches_oracle(sample_config, rng):
    spec, params = net_from_config(sample_config)
    x = (rng.random((5, 290)) * 1e-4).astype(np.float32)
    got = np.asarray(apply_net(spec, params, jnp.asarray(x)))
    want = np.stack([ref.net_apply(sample_config, xi) for xi in x])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_offline_outputs_vs_oracle(sample_config, rng):
    x = make_audio(rng, seconds=0.5)
    spec, params = detector_spec_from_config(sample_config)
    got = np.asarray(offline_outputs(spec, params, jnp.asarray(x)))
    want = ref.detect_offline(sample_config, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)


def test_offline_rfft_matches_matmul(sample_config, rng):
    x = make_audio(rng, seconds=0.25)
    spec, params = detector_spec_from_config(sample_config)
    a = np.asarray(offline_outputs(spec, params, jnp.asarray(x), method="matmul"))
    b = np.asarray(offline_outputs(spec, params, jnp.asarray(x), method="rfft"))
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=2e-4)


def test_streaming_step_equals_offline(sample_config, rng):
    x = make_audio(rng, seconds=0.6)
    spec, params = detector_spec_from_config(sample_config)
    hop = spec.hop
    r = spec.residual

    h_hops = 16
    usable = (len(x) - r) // (h_hops * hop)
    stream = x[: r + usable * h_hops * hop]

    carry = streaming_init(spec, prefix=jnp.asarray(stream[:r]))
    outs = []
    for k in range(usable):
        chunk = stream[r + k * h_hops * hop : r + (k + 1) * h_hops * hop]
        carry, o = streaming_step(spec, params, carry, jnp.asarray(chunk))
        outs.append(np.asarray(o))
    got = np.concatenate(outs)[spec.history :]  # drop warm-up rows

    want = np.asarray(offline_outputs(spec, params, jnp.asarray(stream)))
    np.testing.assert_allclose(got[: len(want)], want, rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("method", ["matmul", "rfft"])
@pytest.mark.parametrize("chunk_size", [173, 1024, 8000, 10**9])
def test_host_detector_chunk_invariance(sample_config, rng, chunk_size, method):
    x = make_audio(rng, seconds=0.5)
    spec, params = detector_spec_from_config(sample_config)
    want = np.asarray(offline_outputs(spec, params, jnp.asarray(x)))

    det = Detector(sample_config, method=method)
    outs = []
    for start in range(0, len(x), chunk_size):
        det.append_audio_data(x[start : start + chunk_size])
        o = det.drain()
        if len(o):
            outs.append(o)
    got = np.concatenate(outs) if outs else np.zeros((0, 1), np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)


def test_detector_last_outputs_and_seen(sample_config, rng):
    x = make_audio(rng, seconds=0.3)
    det = Detector(sample_config)
    det.append_audio_data(x)
    outs = det.drain()
    assert len(outs) > 0
    np.testing.assert_array_equal(det.last_outputs, outs[-1])
    det2 = Detector(sample_config)
    det2.append_audio_data(x)
    seen = det2.seen_syllable()
    assert seen == bool(np.any(outs[:, 0] >= np.float32(det2.spec.thresholds[0])))


@pytest.mark.parametrize("method", ["matmul", "rfft"])
def test_detector_state_checkpoint_resume(sample_config, rng, tmp_path, method):
    """Snapshot mid-stream, resume in a FRESH detector (new process
    equivalent), outputs match an uninterrupted run exactly."""
    x = make_audio(rng, seconds=0.6)
    cut = len(x) // 3 + 41  # awkward offset: mid-hop, mid-frame

    base = Detector(sample_config, method=method)
    base.append_audio_data(x)
    want = base.drain()

    d1 = Detector(sample_config, method=method)
    d1.append_audio_data(x[:cut])
    first = d1.drain()
    path = tmp_path / "state.npz"
    d1.save_state(path)

    d2 = Detector(sample_config, method=method)
    d2.load_state(path)
    d2.append_audio_data(x[cut:])
    rest = d2.drain()

    got = np.concatenate([first, rest]) if len(first) or len(rest) else first
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(d2.last_outputs, want[-1])

    bad = Detector(sample_config)
    state = d1.get_state()
    state["history"] = state["history"][:, :3]
    with pytest.raises(ValueError, match="history shape"):
        bad.set_state(state)


def test_detector_state_preserves_interleave_carry(sample_config, rng, tmp_path):
    """Checkpoint/restore mid-interleaved-capture keeps the pending
    partial frame: chunk lengths that are NOT multiples of ``channels``
    leave a carry in _interleave_rem, and dropping it on restore would
    permanently swap which interleaved slot each lane reads."""
    channels, channel = 2, 1
    x = make_audio(rng, seconds=0.5)
    other = make_audio(rng, seconds=0.5)
    inter = np.empty(2 * len(x), np.float32)
    inter[0::2], inter[1::2] = other, x  # our channel is slot 1

    base = Detector(sample_config)
    base.append_audio_data(x)
    want = base.drain()

    d1 = Detector(sample_config)
    cut = len(inter) // 2 + 7  # odd: mid-frame, carry pending
    d1.append_interleaved_data(inter[:cut], channels, channel)
    first = d1.drain()
    assert len(d1.get_state()["interleave_rem"]) == 1
    path = tmp_path / "state.npz"
    d1.save_state(path)

    d2 = Detector(sample_config)
    d2.load_state(path)
    d2.append_interleaved_data(inter[cut:], channels, channel)
    rest = d2.drain()

    got = np.concatenate([first, rest]) if len(first) or len(rest) else first
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_spec_validation(sample_config):
    import dataclasses

    bad = dataclasses.replace(sample_config, time_range=9)
    with pytest.raises(ValueError, match="inputs"):
        detector_spec_from_config(bad)
    bad2 = dataclasses.replace(sample_config, thresholds=[0.5, 0.5])
    with pytest.raises(ValueError, match="outputs"):
        detector_spec_from_config(bad2)
    bad3 = dataclasses.replace(sample_config, freq_range=(30000.0, 40000.0))
    with pytest.raises(ValueError, match="frequency range"):
        detector_spec_from_config(bad3)


def test_streaming_scan_equals_offline(sample_config, rng):
    from syllable_detector_tpu.models.detector import streaming_scan

    x = make_audio(rng, seconds=0.7)
    spec, params = detector_spec_from_config(sample_config)
    got = np.asarray(streaming_scan(spec, params, jnp.asarray(x), chunk_hops=8))
    # the trailing partial chunk is processed too: full eval-count parity
    want = np.asarray(offline_outputs(spec, params, jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)


def test_streaming_scan_partial_tail(sample_config, rng):
    """Signal lengths that are not a whole number of chunks still produce
    every evaluation offline_outputs would (ADVICE r1: trailing chunk)."""
    from syllable_detector_tpu.models.detector import streaming_scan

    spec, params = detector_spec_from_config(sample_config)
    hop = spec.hop
    for extra in (1, hop - 1, 3 * hop + 7):
        n = spec.residual + 8 * hop * 3 + extra
        x = make_audio(rng, seconds=1.0)[:n]
        got = np.asarray(
            streaming_scan(spec, params, jnp.asarray(x), chunk_hops=8)
        )
        want = np.asarray(offline_outputs(spec, params, jnp.asarray(x)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)


def test_warm_up_compiles_all_drain_shapes(sample_config):
    """After warm_up, a streaming drain hits only pre-compiled shapes — the
    compile-budget contract for live sessions (a cold bucket would stall
    the stream for a compile)."""
    from syllable_detector_tpu.models import detector as detector_mod

    rng = np.random.default_rng(31)
    det = Detector(sample_config)
    assert det.warm_up(buckets=(8, 32)) == 2
    size1 = detector_mod._drain_step._cache_size()
    det.append_audio_data(make_audio(rng, seconds=0.05))
    det.drain()
    det.append_audio_data(make_audio(rng, seconds=0.08))
    det.drain()
    assert detector_mod._drain_step._cache_size() == size1


def test_streaming_precondition_errors(sample_config):
    """Mis-sized prefix/chunk raise ValueError (not a vanishing assert):
    a silent size mismatch would shift every output's sample accounting."""
    import jax.numpy as jnp
    import pytest

    from syllable_detector_tpu.models.detector import (
        detector_spec_from_config,
        streaming_init,
        streaming_step,
    )

    spec, params = detector_spec_from_config(sample_config)
    with pytest.raises(ValueError, match="residual"):
        streaming_init(spec, prefix=jnp.zeros(spec.residual + 1))
    carry = streaming_init(spec)
    with pytest.raises(ValueError, match="multiple of the"):
        streaming_step(spec, params, carry, jnp.zeros(spec.hop + 1))


def test_detector_streaming_deep_net(sample_config, rng):
    """A 2-hidden-layer net through the LIVE Detector streaming path at
    odd chunkings must match the offline oracle — the train CLI emits
    such nets for --hidden H1 H2."""
    from syllable_detector_tpu.utils.synth import (
        deepen_net as _deepen,
    )

    from syllable_detector_tpu.training.trainer import (
        TrainSettings,
        export_trained_config,
    )

    spec, params = detector_spec_from_config(sample_config)
    spec2, params2 = _deepen(spec, params)
    cfg2 = export_trained_config(TrainSettings(), spec2.net, params2, 0.5)
    assert [l.outputs for l in cfg2.layers] == [4, 6, 1]

    audio = make_audio(rng, seconds=0.7)
    det = Detector(cfg2)
    outs = []
    pos = 0
    for size in (1307, 997, 4099, 256, 9000):
        det.append_audio_data(audio[pos : pos + size])
        pos += size
        outs.append(det.drain())
    det.append_audio_data(audio[pos:])
    outs.append(det.drain())
    got = np.concatenate([o for o in outs if len(o)])

    spec_rt, params_rt = detector_spec_from_config(cfg2)
    want = np.asarray(offline_outputs(spec_rt, params_rt, jnp.asarray(audio)))
    np.testing.assert_allclose(
        got, want[: len(got)], rtol=1e-3, atol=2e-4
    )
    assert len(got) >= len(want) - 8  # all but the tail partial drains out


def test_detector_note_gap_rewarmup(sample_config, rng):
    """note_gap closes the stream at a capture discontinuity: post-gap
    outputs must match a FRESH detector fed only the post-gap audio
    (windows never straddle the hole; the warm-up rule of
    SyllableDetector.swift:164-178 re-applies)."""
    pre = make_audio(rng, seconds=0.25)
    post = make_audio(rng, seconds=0.25) * 0.7

    det = Detector(sample_config)
    det.append_audio_data(pre)
    pre_outs = det.drain()
    det.note_gap(12345)  # n is bookkeeping-only on a plain Detector
    det.append_audio_data(post)
    got = det.drain()

    fresh = Detector(sample_config)
    fresh.append_audio_data(post)
    want = fresh.drain()
    np.testing.assert_array_equal(got, want)

    # and the pre-gap outputs were the uninterrupted prefix
    oracle = Detector(sample_config)
    oracle.append_audio_data(pre)
    np.testing.assert_array_equal(pre_outs, oracle.drain())


def test_detector_note_gap_discards_interleave_carry(sample_config, rng):
    """A pending partial interleaved frame is PRE-gap audio: note_gap must
    discard it, or the next append_interleaved_data would glue a stale
    sample onto the post-gap stream and shift the de-interleave framing."""
    channels, channel = 2, 0
    pre = make_audio(rng, seconds=0.2)
    post = make_audio(rng, seconds=0.2) * 0.8
    inter_pre = np.repeat(pre, channels)[:-1]  # odd: carry pending
    inter_post = np.repeat(post, channels)

    det = Detector(sample_config)
    det.append_interleaved_data(inter_pre, channels, channel)
    det.drain()
    assert len(det.get_state()["interleave_rem"]) == 1
    det.note_gap()
    assert len(det.get_state()["interleave_rem"]) == 0
    det.append_interleaved_data(inter_post, channels, channel)
    got = det.drain()

    fresh = Detector(sample_config)
    fresh.append_interleaved_data(inter_post, channels, channel)
    np.testing.assert_array_equal(got, fresh.drain())
