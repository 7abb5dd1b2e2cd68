"""Multi-process lane-sharded bank: parity vs the single-process
DetectorBank oracle, gap/overflow aggregation, fallback routing, and
lifecycle. Workers do all staging in their own process; the parent
serves every staged round on the (CPU-forced, here) device — so a green
parity test pins the whole shared-memory wire protocol, not just the
math (which is literally the same code on both sides)."""

import dataclasses

import numpy as np
import pytest

from syllable_detector_tpu.config.model_format import ProcessingSpec
from syllable_detector_tpu.models.detector_bank import DetectorBank
from syllable_detector_tpu.runtime.shard_bank import ShardedDetectorBank

from test_detector import make_audio
from test_detector_bank import _perturbed_cfg


@pytest.mark.parametrize("wire", ["float32", "int16"])
def test_sharded_bank_matches_single_process(sample_config, wire):
    """5 lanes over 2 workers (uneven 3+2 shard split), distinct nets,
    uneven fills, a mid-stream gap, multi-round drains incl. a final
    flush: outputs, counts, and absolute sample indices must be
    bit-identical to one in-process DetectorBank fed the same stream."""
    n = 5
    cfgs = [_perturbed_cfg(sample_config, i) for i in range(n)]
    rng = np.random.default_rng(11)
    streams = [
        make_audio(rng, seconds=0.35 + 0.05 * i) * 1.1 for i in range(n)
    ]

    oracle = DetectorBank(cfgs, transfer_dtype=wire, buckets=(8, 32))
    with ShardedDetectorBank(
        cfgs, n_workers=2, transfer_dtype=wire, buckets=(8, 32)
    ) as bank:
        for r in range(4):
            flush = r == 3
            for i, s in enumerate(streams):
                lo = r * len(s) // 4
                hi = (r + 1) * len(s) // 4
                chunk = s[lo:hi]
                if r == 2 and i in (1, 4):
                    bank.note_gap(i, 777)
                    oracle.note_gap(i, 777)
                bank.append_audio_data(i, chunk)
                oracle.append_audio_data(i, chunk)
            got = bank.drain(flush=flush)
            want = oracle.drain(flush=flush)
            np.testing.assert_array_equal(bank.last_counts, oracle.last_counts)
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)
            for i in range(n):
                np.testing.assert_array_equal(
                    bank.last_sample_indices[i], oracle.last_sample_indices[i]
                )
            np.testing.assert_array_equal(bank.last_outputs, oracle.last_outputs)
        assert bank.hops_emitted == oracle.hops_emitted


def test_sharded_bank_overflow_accounting(sample_config):
    """Buffer-cap overflows happen inside the WORKER's bank; the parent's
    per-lane overflow/dropped totals must aggregate them, and post-drop
    outputs must match an oracle with the same cap."""
    cfgs = [_perturbed_cfg(sample_config, i) for i in range(2)]
    rng = np.random.default_rng(3)
    big = make_audio(rng, seconds=1.2)
    kw = dict(max_buffer_seconds=0.5, buckets=(8,), min_drain_hops=1)
    oracle = DetectorBank(cfgs, **kw)
    with ShardedDetectorBank(cfgs, n_workers=2, **kw) as bank:
        for i in range(2):
            bank.append_audio_data(i, big)
            oracle.append_audio_data(i, big)
        got = bank.drain(flush=True)
        want = oracle.drain(flush=True)
        np.testing.assert_array_equal(got, want)
        assert bank.overflows == oracle.overflows
        assert bank.dropped_samples == oracle.dropped_samples
        assert sum(bank.overflows) > 0  # the cap actually tripped


def test_sharded_bank_unfusable_routes_matmul(sample_config):
    """A chain the affine fold cannot express (``normalize``) drains on
    BOTH sides (worker staging + parent eval) and matches the oracle."""
    cfg = dataclasses.replace(
        sample_config, process_inputs=[ProcessingSpec("normalize")]
    )
    cfgs = [cfg, cfg]
    audio = make_audio(np.random.default_rng(5), seconds=0.4)
    oracle = DetectorBank(cfgs, buckets=(16,))
    with ShardedDetectorBank(cfgs, n_workers=2, buckets=(16,)) as bank:
        for i in range(2):
            bank.append_audio_data(i, audio)
            oracle.append_audio_data(i, audio)
        got = bank.drain(flush=True)
        want = oracle.drain(flush=True)
        np.testing.assert_array_equal(bank.last_counts, oracle.last_counts)
        np.testing.assert_array_equal(got, want)


def test_sharded_bank_seen_and_lifecycle(sample_config):
    """seen_syllables drains through the wire; close() is idempotent and
    a drain after close raises instead of hanging."""
    cfgs = [sample_config] * 3
    rng = np.random.default_rng(9)
    audio = make_audio(rng, seconds=0.5) * 1.5
    oracle = DetectorBank(cfgs, buckets=(32,))
    bank = ShardedDetectorBank(cfgs, n_workers=3, buckets=(32,))
    try:
        for i in range(3):
            bank.append_audio_data(i, audio)
            oracle.append_audio_data(i, audio)
        np.testing.assert_array_equal(
            bank.seen_syllables(), oracle.seen_syllables()
        )
    finally:
        bank.close()
    bank.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        bank.drain()


def test_sharded_bank_workers_start_no_jax_backend(sample_config):
    """Workers stage audio only: after appends and drains none of them
    has started a JAX backend (on a GPU host one would reserve most of
    the card the parent serves from)."""
    cfgs = [_perturbed_cfg(sample_config, i) for i in range(2)]
    audio = make_audio(np.random.default_rng(6), seconds=0.3)
    with ShardedDetectorBank(cfgs, n_workers=2, buckets=(32,)) as bank:
        for i in range(2):
            bank.append_audio_data(i, audio)
        bank.drain(flush=True)
        assert bank.worker_backends_initialized() == [False, False]


def test_sharded_bank_validates_args(sample_config):
    with pytest.raises(ValueError, match="n_workers"):
        ShardedDetectorBank([sample_config], n_workers=2)
    with pytest.raises(ValueError, match="transfer_dtype"):
        ShardedDetectorBank([sample_config], n_workers=1, transfer_dtype="f8")
