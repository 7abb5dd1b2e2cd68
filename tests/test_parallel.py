"""Mesh sharding tests on the 8-device virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from syllable_detector_tpu.models.detector import (
    detector_spec_from_config,
    offline_outputs,
    streaming_init,
)
from syllable_detector_tpu.models.neural_net import stack_params
from syllable_detector_tpu.parallel.mesh import (
    batch_offline_outputs,
    make_mesh,
    sharded_detection_counts,
    sharded_offline_outputs,
    sharded_streaming_step,
)
from test_detector import make_audio


@pytest.fixture(scope="module")
def setup(sample_config):
    spec, params = detector_spec_from_config(sample_config)
    c = 8
    rng = np.random.default_rng(5)
    xs = np.stack([make_audio(rng, seconds=0.3) for _ in range(c)])
    stacked = stack_params([params] * c)
    return spec, params, stacked, jnp.asarray(xs)


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8
    assert jax.devices()[0].platform == "cpu"


def test_batch_matches_single(setup):
    spec, params, stacked, xs = setup
    batched = np.asarray(batch_offline_outputs(spec, stacked, xs))
    single0 = np.asarray(offline_outputs(spec, params, xs[0]))
    np.testing.assert_allclose(batched[0], single0, rtol=1e-5, atol=1e-6)


def test_sharded_matches_batched(setup):
    spec, params, stacked, xs = setup
    mesh = make_mesh(8)
    sharded = np.asarray(sharded_offline_outputs(mesh, spec, stacked, xs))
    batched = np.asarray(batch_offline_outputs(spec, stacked, xs))
    np.testing.assert_allclose(sharded, batched, rtol=1e-5, atol=1e-6)


def test_sharded_detection_counts(setup):
    spec, params, stacked, xs = setup
    mesh = make_mesh(8)
    counts = np.asarray(sharded_detection_counts(mesh, spec, stacked, xs))
    outs = np.asarray(batch_offline_outputs(spec, stacked, xs))
    want = np.sum(outs >= np.asarray(spec.thresholds, np.float32), axis=(0, 1))
    np.testing.assert_array_equal(counts, want)
    assert counts[0] > 0  # the chirp fixture detects


def test_sharded_streaming_step(setup):
    spec, params, stacked, xs = setup
    mesh = make_mesh(8)
    c = xs.shape[0]
    hop = spec.hop
    h_hops = 8
    r = spec.residual

    carry0 = streaming_init(spec)
    carries = jax.tree.map(lambda a: jnp.stack([a] * c), carry0)
    # prime residuals with each stream's prefix
    carries["residual"] = xs[:, :r]

    chunks = xs[:, r : r + h_hops * hop]
    new_carries, outs = sharded_streaming_step(mesh, spec, stacked, carries, chunks)
    assert outs.shape == (c, h_hops, spec.net.outputs)

    # channel 0 must agree with the unsharded streaming step
    from syllable_detector_tpu.models.detector import streaming_step

    carry_ref = streaming_init(spec, prefix=xs[0, :r])
    _, outs_ref = streaming_step(spec, params, carry_ref, chunks[0])
    np.testing.assert_allclose(
        np.asarray(outs[0]), np.asarray(outs_ref), rtol=1e-5, atol=1e-6
    )


def test_1024_channels_on_virtual_mesh(sample_config):
    """Thousands of detector lanes per step: 1024 channels, 8 devices,
    distinct stacked nets, one sharded streaming step (tiny shapes)."""
    spec, params = detector_spec_from_config(sample_config)
    c = 1024
    mesh = make_mesh(8)
    stacked = jax.tree.map(
        lambda a: jnp.broadcast_to(a, (c,) + a.shape), params
    )
    carry0 = streaming_init(spec)
    carries = jax.tree.map(
        lambda a: jnp.broadcast_to(a, (c,) + a.shape), carry0
    )
    hop = spec.hop
    rng = np.random.default_rng(0)
    chunks = jnp.asarray(
        rng.standard_normal((c, 2 * hop)).astype(np.float32) * 0.1
    )
    new_carries, outs = sharded_streaming_step(mesh, spec, stacked, carries, chunks)
    assert outs.shape == (c, 2, spec.net.outputs)
    assert bool(jnp.all(jnp.isfinite(outs)))


def test_time_sharded_matches_offline(setup):
    """Sequence parallelism: one long stream's time axis sharded over all 8
    devices with a ppermute halo exchange must equal the single-device
    offline path exactly (SURVEY section 5's halo-exchange design)."""
    from syllable_detector_tpu.parallel.mesh import time_sharded_offline_outputs

    spec, params, _, _ = setup
    rng = np.random.default_rng(7)
    x = jnp.asarray(make_audio(rng, seconds=2.3))  # not divisible by 8 evals
    mesh = make_mesh(8, axis="time")
    got = np.asarray(time_sharded_offline_outputs(mesh, spec, params, x))
    want = np.asarray(offline_outputs(spec, params, x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_time_sharded_gap_config(sample_config):
    """The halo must include the inter-window gap (negative overlap)."""
    import dataclasses

    from syllable_detector_tpu.parallel.mesh import time_sharded_offline_outputs

    cfg = dataclasses.replace(sample_config, window_overlap=-40)
    spec, params = detector_spec_from_config(cfg)
    rng = np.random.default_rng(8)
    x = jnp.asarray(make_audio(rng, seconds=2.0))
    mesh = make_mesh(4, axis="time")
    got = np.asarray(time_sharded_offline_outputs(mesh, spec, params, x))
    want = np.asarray(offline_outputs(spec, params, x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_time_sharded_short_stream_falls_back(setup):
    """Streams shorter than one halo per device just run unsharded."""
    from syllable_detector_tpu.parallel.mesh import time_sharded_offline_outputs

    spec, params, _, _ = setup
    rng = np.random.default_rng(9)
    x = jnp.asarray(make_audio(rng, seconds=0.06))
    mesh = make_mesh(8, axis="time")
    got = np.asarray(time_sharded_offline_outputs(mesh, spec, params, x))
    want = np.asarray(offline_outputs(spec, params, x))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scaling", ["linear", "log", "db"])
def test_tensor_sharded_matches_offline(sample_config, scaling):
    """Tensor parallelism: the feature/bin axis sharded over 8 devices with
    one psum must match the single-device detector (29 bins -> 4-bin shards
    with zero padding; log scaling exercises the padded-lane masking)."""
    import dataclasses

    from syllable_detector_tpu.parallel.mesh import (
        tensor_sharded_offline_outputs,
    )

    cfg = dataclasses.replace(sample_config, scaling=scaling)
    spec, params = detector_spec_from_config(cfg)
    rng = np.random.default_rng(11)
    x = jnp.asarray(make_audio(rng, seconds=0.5))
    mesh = make_mesh(8, axis="model")
    got = np.asarray(tensor_sharded_offline_outputs(mesh, spec, params, x))
    want = np.asarray(offline_outputs(spec, params, x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_tensor_sharded_setup_cached(sample_config, monkeypatch):
    """Second call does NO numpy fold work and no retrace (r2 VERDICT:
    tensor_sharded re-folded and re-jitted per call)."""
    from syllable_detector_tpu.parallel import mesh as mesh_mod

    spec, params = detector_spec_from_config(sample_config)
    calls = {"n": 0}
    real = mesh_mod._tp_constants

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(mesh_mod, "_tp_constants", counted)
    rng = np.random.default_rng(40)
    x = jnp.asarray(make_audio(rng, seconds=0.4))
    m = make_mesh(4, axis="model")
    a = np.asarray(mesh_mod.tensor_sharded_offline_outputs(m, spec, params, x))
    b = np.asarray(mesh_mod.tensor_sharded_offline_outputs(m, spec, params, x))
    np.testing.assert_array_equal(a, b)
    assert calls["n"] == 1  # constants folded exactly once
    fn = mesh_mod._sharded_fn_cache[("tp", spec, id(params), m, a.shape[0] + spec.time_range - 1)][0]
    assert fn._cache_size() == 1  # one trace total across both calls


def test_time_sharded_setup_cached(sample_config):
    from syllable_detector_tpu.parallel import mesh as mesh_mod
    from syllable_detector_tpu.parallel.mesh import time_sharded_offline_outputs

    spec, params = detector_spec_from_config(sample_config)
    rng = np.random.default_rng(41)
    x = jnp.asarray(make_audio(rng, seconds=2.0))
    m = make_mesh(4, axis="time")
    a = np.asarray(time_sharded_offline_outputs(m, spec, params, x))
    key = next(
        k
        for k in mesh_mod._sharded_fn_cache
        if k[0] == "sp" and k[2] == id(params)
    )
    fn = mesh_mod._sharded_fn_cache[key][0]
    b = np.asarray(time_sharded_offline_outputs(m, spec, params, x))
    np.testing.assert_array_equal(a, b)
    # the second call reused the SAME jitted callable with no retrace
    # (the shared LRU may hold entries from other tests; check the key,
    # not the global cache length)
    assert mesh_mod._sharded_fn_cache[key][0] is fn
    assert fn._cache_size() == 1


def test_time_sharded_rfft_method(setup):
    """Sequence parallelism with the rfft spectral backend per shard."""
    from syllable_detector_tpu.parallel.mesh import time_sharded_offline_outputs

    spec, params, _, _ = setup
    rng = np.random.default_rng(12)
    x = jnp.asarray(make_audio(rng, seconds=2.0))
    mesh = make_mesh(4, axis="time")
    got = np.asarray(
        time_sharded_offline_outputs(mesh, spec, params, x, method="rfft")
    )
    want = np.asarray(offline_outputs(spec, params, x, method="rfft"))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("distinct", [False, True])
def test_sharded_corpus_matches_vmap(setup, distinct):
    """The corpus scan's channel-sharded path (``cli --batched --mesh``)
    with a shared or DISTINCT per-channel nets equals the one-device vmap."""
    from syllable_detector_tpu.corpus import (
        sharded_batch_offline_outputs_shared,
    )
    from syllable_detector_tpu.utils.synth import perturbed_params

    spec, params, stacked, xs = setup
    mesh = make_mesh(4)
    if distinct:
        plist = [perturbed_params(params, i) for i in range(xs.shape[0])]
        got = sharded_batch_offline_outputs_shared(mesh, spec, plist, xs)
        want = batch_offline_outputs(spec, stack_params(plist), xs)
    else:
        got = sharded_batch_offline_outputs_shared(mesh, spec, params, xs)
        want = batch_offline_outputs(spec, stacked, xs)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-6
    )
