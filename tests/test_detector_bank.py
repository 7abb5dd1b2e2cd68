"""DetectorBank: batched multi-lane streaming drain must equal a bank of
independent Detectors fed the same streams (distinct nets, odd chunkings)."""

import copy

import numpy as np
import pytest

from syllable_detector_tpu.models.detector import Detector
from syllable_detector_tpu.models.detector_bank import DetectorBank
from test_detector import make_audio


def _perturbed_cfg(cfg, seed, threshold_scale=1.0):
    c2 = copy.deepcopy(cfg)
    r = np.random.default_rng(seed)
    for l in c2.layers:
        l.weights = (
            l.weights * (1.0 + 0.05 * r.standard_normal(l.weights.shape))
        ).astype(np.float32)
    c2.thresholds = [t * threshold_scale for t in cfg.thresholds]
    return c2


@pytest.mark.parametrize("buckets", [None, (8, 32)])
def test_bank_matches_independent_detectors(sample_config, buckets):
    cfgs = [
        sample_config,
        _perturbed_cfg(sample_config, 1, 0.9),
        _perturbed_cfg(sample_config, 2, 1.1),
    ]
    bank = DetectorBank(cfgs, buckets=buckets)
    # oracle: independent streaming Detectors (host path, proven vs the
    # reference oracle in test_detector.py)
    singles = [Detector(c) for c in cfgs]

    rng = np.random.default_rng(5)
    streams = [make_audio(rng, seconds=0.5) for _ in cfgs]

    # feed in odd-sized chunks and drain at irregular points
    bank_outs = [[] for _ in cfgs]
    single_outs = [[] for _ in cfgs]
    pos = 0
    for chunk_len in (700, 133, 4096, 51, 9000, 10**9):
        end = min(pos + chunk_len, len(streams[0]))
        for i in range(len(cfgs)):
            bank.append_audio_data(i, streams[i][pos:end])
            singles[i].append_audio_data(streams[i][pos:end])
        outs = bank.drain()
        for i in range(len(cfgs)):
            if outs.shape[1]:
                bank_outs[i].append(outs[i])
            s = singles[i].drain()
            if len(s):
                single_outs[i].append(s)
        pos = end
        if pos >= len(streams[0]):
            break

    for i in range(len(cfgs)):
        got = np.concatenate(bank_outs[i], axis=0)
        want = np.concatenate(single_outs[i], axis=0)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)
    # distinct nets genuinely produced distinct outputs
    a = np.concatenate(bank_outs[0], axis=0)
    b = np.concatenate(bank_outs[1], axis=0)
    assert np.abs(a - b).max() > 1e-4

    # last_outputs mirrors the final drained row per lane
    np.testing.assert_allclose(
        bank.last_outputs[0], np.concatenate(bank_outs[0], axis=0)[-1]
    )


def test_bank_lanes_progress_independently(sample_config):
    """A starved lane must not stall the others (the reference drains each
    channel independently, Processor.swift:102-149): lane 0's hops emit
    immediately, lane 1's count stays 0 until it is fed, then it catches
    up with identical outputs."""
    bank = DetectorBank([sample_config, sample_config])
    rng = np.random.default_rng(6)
    x = make_audio(rng, seconds=0.2)
    bank.append_audio_data(0, x)  # lane 1 has nothing yet
    outs = bank.drain()
    assert outs.shape[1] > 0  # lane 0 emits without waiting
    assert bank.last_counts[0] == outs.shape[1]
    assert bank.last_counts[1] == 0
    lane0 = outs[0, : bank.last_counts[0]].copy()
    idx0 = bank.last_sample_indices[0].copy()
    bank.append_audio_data(1, x)
    outs = bank.drain()
    assert bank.last_counts[0] == 0  # no new lane-0 audio
    assert bank.last_counts[1] == len(lane0)  # lane 1 catches up
    np.testing.assert_allclose(
        outs[1, : bank.last_counts[1]], lane0, rtol=1e-5, atol=1e-6
    )
    np.testing.assert_array_equal(bank.last_sample_indices[1], idx0)


def test_bank_starved_lane_does_not_stall_others(sample_config):
    """The round-3 verdict's scenario: one dead capture lane in a 4-lane
    bank. The other lanes' outputs must match independent detectors with
    NO overflow drops (previously the min-over-lanes lockstep stalled
    every lane until the cap started dropping audio)."""
    cfgs = [
        sample_config,
        _perturbed_cfg(sample_config, 21),
        _perturbed_cfg(sample_config, 22),
        _perturbed_cfg(sample_config, 23),
    ]
    bank = DetectorBank(cfgs, max_buffer_seconds=5.0)
    singles = {i: Detector(cfgs[i]) for i in (0, 2, 3)}
    rng = np.random.default_rng(24)
    streams = {i: make_audio(rng, seconds=0.4) for i in (0, 2, 3)}

    got = {i: [] for i in (0, 2, 3)}
    want = {i: [] for i in (0, 2, 3)}
    pos = 0
    for chunk in (5000, 3000, 9641):
        for i in (0, 2, 3):  # lane 1 is dead: never fed
            bank.append_audio_data(i, streams[i][pos : pos + chunk])
            singles[i].append_audio_data(streams[i][pos : pos + chunk])
        outs = bank.drain()
        assert bank.last_counts[1] == 0
        for i in (0, 2, 3):
            if bank.last_counts[i]:
                got[i].append(outs[i, : bank.last_counts[i]])
            s = singles[i].drain()
            if len(s):
                want[i].append(s)
        pos += chunk
    assert bank.overflows == [0, 0, 0, 0]
    for i in (0, 2, 3):
        g = np.concatenate(got[i], axis=0)
        w = np.concatenate(want[i], axis=0)
        assert g.shape == w.shape and g.shape[0] > 0
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=2e-4)


def test_bank_overflow_gap_keeps_sample_accuracy(sample_config):
    """A chunk dropped at the buffer cap advances the lane's stream clock
    and closes the segment: post-gap outputs equal a fresh detector fed
    only the post-gap audio, and their sample indices are the TRUE stream
    positions (TrackDetector.swift:67-68 accounting)."""
    cfg = sample_config
    rate = int(cfg.sampling_rate)
    bank = DetectorBank([cfg], max_buffer_seconds=0.25)
    cap = bank.max_buffer_samples
    rng = np.random.default_rng(30)
    pre = make_audio(rng, seconds=0.2)
    lost = make_audio(rng, seconds=0.3)  # > remaining cap: dropped whole
    post = make_audio(rng, seconds=0.2)

    assert bank.append_audio_data(0, pre)
    assert not bank.append_audio_data(0, lost)  # overflow drop
    outs1 = bank.drain()  # pre-gap hops drain normally
    n_pre = int(bank.last_counts[0])
    assert n_pre > 0
    idx_pre = bank.last_sample_indices[0]
    # pre-gap indices: first output at first_output_sample, +hop each
    assert idx_pre[0] == cfg.first_output_sample
    assert np.all(np.diff(idx_pre) == cfg.hop)

    assert bank.append_audio_data(0, post)  # accepted after the drain
    outs2 = bank.drain()
    n_post = int(bank.last_counts[0])
    assert n_post > 0
    # oracle: a fresh detector fed ONLY the post-gap audio (the lane
    # re-warms on the far side of the gap like a fresh stream)
    oracle = Detector(cfg)
    oracle.append_audio_data(post)
    want = oracle.drain()
    np.testing.assert_allclose(
        outs2[0, :n_post], want, rtol=1e-3, atol=2e-4
    )
    # post-gap indices are offset by the TRUE stream position of the
    # post-gap segment: len(pre) + len(lost)
    gap_start = len(pre) + len(lost)
    idx_post = bank.last_sample_indices[0]
    assert idx_post[0] == gap_start + cfg.first_output_sample
    assert np.all(np.diff(idx_post) == cfg.hop)
    assert bank.overflows[0] == 1
    assert bank.dropped_samples[0] == len(lost)


def test_bank_seen_syllables_per_lane_thresholds(sample_config):
    low = _perturbed_cfg(sample_config, 0, threshold_scale=1.0)
    high = copy.deepcopy(sample_config)
    high.thresholds = [2.0]  # unreachable: outputs map to [0, 1]
    bank = DetectorBank([low, high])
    rng = np.random.default_rng(7)
    x = make_audio(rng, seconds=0.5)
    bank.append_audio_data(0, x)
    bank.append_audio_data(1, x)
    seen = bank.seen_syllables()
    assert seen[0] and not seen[1]


def test_bank_geometry_mismatch_rejected(sample_config):
    import dataclasses

    bad = dataclasses.replace(sample_config, scaling="log")
    with pytest.raises(ValueError, match="geometry"):
        DetectorBank([sample_config, bad])


def test_bank_warm_up_no_new_traces(sample_config):
    from syllable_detector_tpu.models.detector_bank import _bank_program

    bank = DetectorBank([sample_config, _perturbed_cfg(sample_config, 9)])
    bank.warm_up(buckets=(8, 32))
    size0 = _bank_program._cache_size()
    rng = np.random.default_rng(8)
    bank.append_audio_data(0, make_audio(rng, seconds=0.05))
    bank.append_audio_data(1, make_audio(rng, seconds=0.05))
    bank.drain()
    assert _bank_program._cache_size() == size0


def test_bank_buffer_cap_bounds_memory(sample_config):
    """Appends beyond max_buffer_seconds (e.g. a caller that stops
    draining) are counted and dropped; the buffer never exceeds the cap."""
    bank = DetectorBank(
        [sample_config, sample_config], max_buffer_seconds=0.1
    )
    cap = bank.max_buffer_samples
    x = np.zeros(2048, np.float32)
    for _ in range(20):  # no drains: the cap must bound lane 0's buffer
        bank.append_audio_data(0, x)
    assert bank.buffered_samples(0) <= cap
    assert bank.overflows[0] > 0
    assert bank.dropped_samples[0] > 0
    assert bank.overflows[1] == 0


def test_bank_matmul_fn_built_once(sample_config):
    """The drain program compiles once per bucket shape (a per-drain jit
    would retrace every call)."""
    from syllable_detector_tpu.models.detector_bank import _bank_program

    bank = DetectorBank([sample_config, sample_config])
    rng = np.random.default_rng(10)
    bank.append_audio_data(0, make_audio(rng, seconds=0.1))
    bank.append_audio_data(1, make_audio(rng, seconds=0.1))
    bank.drain()
    size0 = _bank_program._cache_size()
    # exactly one bucket's worth of new hops: same drain shape as before,
    # so the SAME compiled computation must serve it (no retrace)
    hop = bank.spec.hop
    more = make_audio(rng, seconds=1.0)[: 32 * hop]
    bank.append_audio_data(0, more)
    bank.append_audio_data(1, more)
    bank.drain()
    assert _bank_program._cache_size() == size0


def test_bank_state_checkpoint_resume(sample_config, tmp_path):
    """Snapshot mid-stream, restore into a FRESH bank, outputs continue
    exactly as the uninterrupted bank's."""
    cfgs = [sample_config, _perturbed_cfg(sample_config, 3)]
    rng = np.random.default_rng(11)
    streams = [make_audio(rng, seconds=0.5) for _ in cfgs]

    a = DetectorBank(cfgs)
    for i in range(2):
        a.append_audio_data(i, streams[i][:9000])
    out1 = a.drain()
    p = tmp_path / "bank.npz"
    a.save_state(p)
    for i in range(2):
        a.append_audio_data(i, streams[i][9000:])
    cont = a.drain()

    b = DetectorBank(cfgs)
    b.load_state(p)
    for i in range(2):
        b.append_audio_data(i, streams[i][9000:])
    resumed = b.drain()
    np.testing.assert_allclose(resumed, cont, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b.last_outputs, a.last_outputs)

    wrong = DetectorBank([sample_config])
    with pytest.raises(ValueError, match="lanes"):
        wrong.load_state(p)


def test_interleaved_append(sample_config):
    """appendInterleavedData parity (CircularShortTimeFourierTransform.
    swift:203-217): interleaved capture fans out to lanes / channels with
    outputs equal to pre-deinterleaved feeds."""
    rng = np.random.default_rng(31)
    a = make_audio(rng, seconds=0.25)
    b = make_audio(rng, seconds=0.25)
    inter = np.empty(2 * len(a), np.float32)
    inter[0::2] = a
    inter[1::2] = b

    bank = DetectorBank([sample_config, sample_config])
    ok = bank.append_interleaved_audio_data(inter)
    assert ok == [True, True]
    outs = bank.drain()
    oracle = DetectorBank([sample_config, sample_config])
    oracle.append_audio_data(0, a)
    oracle.append_audio_data(1, b)
    want = oracle.drain()
    np.testing.assert_array_equal(outs, want)

    det = Detector(sample_config)
    det.append_interleaved_data(inter, channels=2, channel=1)
    single = Detector(sample_config)
    single.append_audio_data(b)
    np.testing.assert_array_equal(det.drain(), single.drain())
    import pytest as _pytest

    with _pytest.raises(ValueError, match="out of range"):
        det.append_interleaved_data(inter, channels=2, channel=2)


def test_bank_note_interleaved_gap(sample_config):
    """A gap on the INTERLEAVED capture stream discards the pending
    partial frame (pre-gap audio) and advances every lane's stream clock
    sample-accurately — including the extra carried sample on the lanes
    whose slot it occupied."""
    rng = np.random.default_rng(77)
    a = make_audio(rng, seconds=0.25)
    b = make_audio(rng, seconds=0.25)
    pre = np.empty(2 * len(a), np.float32)
    pre[0::2], pre[1::2] = a, b

    bank = DetectorBank([sample_config, sample_config])
    bank.append_interleaved_audio_data(pre[:-1])  # odd: carry pending
    bank.drain()
    assert len(bank._interleave_rem) == 1

    lost = 2 * 1000  # interleaved samples lost at the gap
    bank.note_interleaved_gap(lost)
    assert len(bank._interleave_rem) == 0
    # lane 0's carried sample is discarded into its gap; lane 1 carried none
    assert bank.dropped_samples == [1001, 1000]
    assert bank.overflows == [1, 1]

    post = np.empty_like(pre)
    post[0::2], post[1::2] = b, a
    bank.append_interleaved_audio_data(post)
    outs = bank.drain()

    fresh = DetectorBank([sample_config, sample_config])
    fresh.append_interleaved_audio_data(post)
    want = fresh.drain()
    np.testing.assert_array_equal(outs, want)
    # post-gap absolute indices advanced past the gapped region:
    # lane 0 offered len(a)-1+1001 pre-gap samples, lane 1 len(b)-1+1000
    for lane, pre_n in ((0, len(a) + 1000), (1, len(b) - 1 + 1000)):
        base = fresh.last_sample_indices[lane]
        np.testing.assert_array_equal(
            bank.last_sample_indices[lane], base + pre_n
        )


@pytest.mark.parametrize("seed", [101, 202, 303])
def test_bank_fuzz_random_lifecycle_vs_segment_oracle(
    sample_config, tmp_path, seed
):
    """Adversarial lifecycle fuzz: random per-lane appends, explicit gaps
    (the overflow path), drains at arbitrary points, and one mid-stream
    save/restore roundtrip. Ground truth is the segment oracle: each
    gap-free run of a lane's stream must produce exactly the outputs of a
    fresh Detector fed that run, with sample indices
    ``segment_start + first_output_sample + k*hop``
    (TrackDetector.swift:38-42, 67-68 accounting)."""
    rng = np.random.default_rng(seed)
    cfgs = [
        sample_config,
        _perturbed_cfg(sample_config, seed + 1),
        _perturbed_cfg(sample_config, seed + 2),
    ]
    n_lanes = len(cfgs)
    streams = [make_audio(rng, seconds=0.8) for _ in cfgs]
    bank = DetectorBank(cfgs)

    # event log per lane: ("data", chunk) | ("gap", n)
    events = [[] for _ in range(n_lanes)]
    pos = [0] * n_lanes
    got_outs = [[] for _ in range(n_lanes)]
    got_idx = [[] for _ in range(n_lanes)]
    n_gaps = [0] * n_lanes
    restored = False

    def collect():
        outs = bank.drain()
        for i in range(n_lanes):
            c = int(bank.last_counts[i])
            if c:
                got_outs[i].append(outs[i, :c])
                got_idx[i].append(bank.last_sample_indices[i])

    for step in range(24):
        for i in range(n_lanes):
            r = rng.random()
            if r < 0.6:  # append a random chunk
                n = int(rng.integers(50, 6000))
                chunk = streams[i][pos[i] : pos[i] + n]
                if len(chunk):
                    assert bank.append_audio_data(i, chunk)
                    events[i].append(("data", chunk))
                    pos[i] += len(chunk)
            elif r < 0.75:  # capture gap (same path as an overflow drop)
                n = int(rng.integers(1, 4000))
                bank.note_gap(i, n)
                events[i].append(("gap", n))
                n_gaps[i] += 1
            # else: lane starved this step
        if rng.random() < 0.4:
            collect()
        if step == 11 and not restored:  # mid-stream checkpoint/restore
            path = tmp_path / "bank.npz"
            bank.save_state(path)
            bank = DetectorBank(cfgs)
            bank.load_state(path)
            restored = True

    # drain everything still evaluable
    for _ in range(8):
        before = sum(len(o) for outs in got_outs for o in outs)
        collect()
        if sum(len(o) for outs in got_outs for o in outs) == before:
            break

    spec = bank.spec
    for i in range(n_lanes):
        # oracle: rebuild the gap-free segments from the event log
        segments = []  # (abs_start, [chunks])
        clock = 0
        open_seg = None
        for kind, payload in events[i]:
            if kind == "data":
                if open_seg is None:
                    open_seg = (clock, [payload])
                    segments.append(open_seg)
                else:
                    open_seg[1].append(payload)
                clock += len(payload)
            else:
                clock += payload
                open_seg = None
        want_rows, want_idx = [], []
        for start, chunks in segments:
            oracle = Detector(cfgs[i])
            oracle.append_audio_data(np.concatenate(chunks))
            o = oracle.drain()
            if len(o):
                want_rows.append(o)
                want_idx.append(
                    start
                    + spec.first_output_sample
                    + spec.hop * np.arange(len(o), dtype=np.int64)
                )
        got = (
            np.concatenate(got_outs[i])
            if got_outs[i]
            else np.zeros((0, spec.net.outputs), np.float32)
        )
        want = (
            np.concatenate(want_rows)
            if want_rows
            else np.zeros((0, spec.net.outputs), np.float32)
        )
        assert got.shape == want.shape, f"lane {i}"
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)
        gidx = (
            np.concatenate(got_idx[i]) if got_idx[i] else np.zeros(0, np.int64)
        )
        widx = (
            np.concatenate(want_idx) if want_idx else np.zeros(0, np.int64)
        )
        np.testing.assert_array_equal(gidx, widx)
        assert bank.overflows[i] == n_gaps[i]
        assert bank.dropped_samples[i] == sum(
            n for k, n in events[i] if k == "gap"
        )


def test_bank_deep_distinct_nets(sample_config):
    """Deep (2-hidden-layer) DISTINCT nets through the bank's batched
    drain match independent detectors — the one-net-per-channel
    deployment with --hidden H1 H2 geometry."""
    from syllable_detector_tpu.utils.synth import (
        deepen_net as _deepen,
    )

    from syllable_detector_tpu.models.detector import (
        detector_spec_from_config,
    )
    from syllable_detector_tpu.training.trainer import (
        TrainSettings,
        export_trained_config,
    )

    spec, params = detector_spec_from_config(sample_config)
    cfgs = []
    for seed in (0, 3):
        spec2, params2 = _deepen(spec, params, seed=seed)
        cfgs.append(
            export_trained_config(TrainSettings(), spec2.net, params2, 0.5)
        )
    bank = DetectorBank(cfgs)
    singles = [Detector(c) for c in cfgs]

    rng = np.random.default_rng(11)
    streams = [make_audio(rng, seconds=0.5) for _ in cfgs]
    outs_bank = [[] for _ in cfgs]
    outs_single = [[] for _ in cfgs]
    pos = 0
    for size in (1307, 997, 4099, 9000):
        for lane, (s, d) in enumerate(zip(streams, singles)):
            bank.append_audio_data(lane, s[pos : pos + size])
            d.append_audio_data(s[pos : pos + size])
        pos += size
        drained = bank.drain()
        for lane in range(len(cfgs)):
            if len(drained[lane]):
                outs_bank[lane].append(drained[lane])
            o = singles[lane].drain()
            if len(o):
                outs_single[lane].append(o)
    for lane in range(len(cfgs)):
        got = np.concatenate(outs_bank[lane])
        want = np.concatenate(outs_single[lane])
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)


def test_bank_wire_typo_raises(sample_config):
    """A misspelled wire format must be loud."""
    with pytest.raises(ValueError, match="unknown transfer_dtype"):
        DetectorBank([sample_config], transfer_dtype="int8")


def test_bank_set_state_restores_or_resets_last_drain_fields(sample_config):
    """last_counts/last_sample_indices travel with the snapshot; a
    snapshot WITHOUT them (legacy) resets both — stale values from the
    restoring process's previous stream must never be attributed to the
    restored one."""
    rng = np.random.default_rng(9)
    a = DetectorBank([sample_config, _perturbed_cfg(sample_config, 1)])
    for i in range(2):
        a.append_audio_data(i, make_audio(rng, seconds=0.3))
    a.drain()
    assert a.last_counts.sum() > 0
    st = a.get_state()

    b = DetectorBank([sample_config, _perturbed_cfg(sample_config, 1)])
    b.set_state(st)
    np.testing.assert_array_equal(b.last_counts, a.last_counts)
    for x, y in zip(b.last_sample_indices, a.last_sample_indices):
        np.testing.assert_array_equal(x, y)

    # legacy snapshot (no last-drain fields): reset, don't leak c's own
    c = DetectorBank([sample_config, _perturbed_cfg(sample_config, 1)])
    for i in range(2):
        c.append_audio_data(i, make_audio(rng, seconds=0.3))
    c.drain()
    assert c.last_counts.sum() > 0
    st2 = a.get_state()
    st2.pop("last_counts")
    st2.pop("last_sample_indices")
    c.set_state(st2)
    np.testing.assert_array_equal(c.last_counts, np.zeros(2, np.int64))
    assert all(len(x) == 0 for x in c.last_sample_indices)


def test_bank_drain_releases_consumed_buffers(sample_config):
    """The post-drain remainder must not be a tiny view pinning the whole
    pre-drain buffer (megabytes per idle lane at deployment scale)."""
    rng = np.random.default_rng(3)
    bank = DetectorBank([sample_config])
    bank.append_audio_data(0, make_audio(rng, seconds=2.0))
    bank.drain()
    segs = bank._segments[0]
    for s in segs:
        base = s.data.base
        assert base is None or base.nbytes <= 2 * s.data.nbytes


def test_bank_small_chunk_appends_linear_and_exact(sample_config):
    """Appends land in the segment's pending chunk list (O(chunk) each,
    consolidated once per drain) — a small-chunk capture loop must not go
    quadratic — and the drained outputs stay identical to one big
    append."""
    rng = np.random.default_rng(11)
    audio = make_audio(rng, seconds=0.4)

    bank = DetectorBank([sample_config])
    pos = 0
    n_chunks = 0
    while pos < len(audio):
        step = int(rng.integers(32, 96))
        bank.append_audio_data(0, audio[pos : pos + step])
        pos += step
        n_chunks += 1
    # bookkeeping sees through the pending list
    assert bank.buffered_samples(0) == len(audio)
    seg = bank._segments[0][0]
    assert len(seg.pending) == n_chunks - 1  # first chunk opened the segment
    got = bank.drain()[0, : bank.last_counts[0]]
    assert not seg.pending  # drain consolidated exactly once

    oracle = DetectorBank([sample_config])
    oracle.append_audio_data(0, audio)
    want = oracle.drain()[0, : oracle.last_counts[0]]
    np.testing.assert_array_equal(got, want)


def test_bank_staging_buffer_reuse_is_clean(sample_config):
    """drain() reuses a per-bucket staging buffer instead of a fresh
    np.zeros per round (the 75 MB-per-drain memset at 1024 lanes). A lane
    whose fill shrinks between drains (long burst, then idle while
    another lane goes on) must leave no stale samples behind: outputs
    must equal a fresh bank fed the same streams."""
    rng = np.random.default_rng(17)
    audio = make_audio(rng, seconds=0.6)
    cfgs = [sample_config, _perturbed_cfg(sample_config, 3)]

    bank = DetectorBank(cfgs)
    # drain 1: lane 0 long, lane 1 silent -> lane 0's row fills wide
    bank.append_audio_data(0, audio[:20000])
    bank.drain()
    assert bank._stage  # the staging buffer exists and persists
    # drain 2: lane 0 idle, lane 1 short -> lane 0's row must be
    # re-zeroed beyond its (empty) fill, lane 1 evaluated cleanly
    bank.append_audio_data(1, audio[:6000])
    outs2 = bank.drain()
    c2 = bank.last_counts.copy()

    fresh = DetectorBank(cfgs)
    fresh.append_audio_data(1, audio[:6000])
    want = fresh.drain()
    np.testing.assert_array_equal(outs2[1, : c2[1]], want[1, : fresh.last_counts[1]])
    assert c2[1] == fresh.last_counts[1]

    # drain 3: lane 0 resumes mid-stream — continuation unaffected by
    # the buffer reuse (residual carry lives in segments, not staging)
    bank.append_audio_data(0, audio[20000:40000])
    outs3 = bank.drain()
    fresh0 = DetectorBank(cfgs)
    fresh0.append_audio_data(0, audio[:40000])
    all0 = fresh0.drain()
    # bank's drains 1+3 concatenated == one-shot drain of the same stream
    n1 = fresh0.last_counts[0]
    # (drain 1's rows were lane 0's first chunk; recompute them)
    bank1 = DetectorBank(cfgs)
    bank1.append_audio_data(0, audio[:20000])
    first = bank1.drain()[0, : bank1.last_counts[0]]
    combined = np.concatenate([first, outs3[0, : bank.last_counts[0]]])
    np.testing.assert_array_equal(combined, all0[0, :n1])


def test_bank_pinned_bucket_ladder_matches_default(sample_config):
    """buckets=(8,) — the live compile-budget pin: ONE compiled drain
    shape; backlogs beyond it drain in multiple 8-hop rounds. Outputs,
    counts, and sample indices must equal the default full-ladder bank."""
    rng = np.random.default_rng(23)
    audio = make_audio(rng, seconds=0.8)
    cfgs = [sample_config, _perturbed_cfg(sample_config, 7)]

    pinned = DetectorBank(cfgs, buckets=(8,))
    full = DetectorBank(cfgs)
    for b in (pinned, full):
        b.append_audio_data(0, audio)
        b.append_audio_data(1, audio[: len(audio) // 2])
    o_p = pinned.drain()
    o_f = full.drain()
    np.testing.assert_array_equal(pinned.last_counts, full.last_counts)
    for i in range(2):
        c = full.last_counts[i]
        # same windows through DIFFERENT launch shapes (8-hop rounds vs
        # one big bucket): values agree to float32 ulps, bookkeeping
        # (counts, stream indices) exactly
        np.testing.assert_allclose(o_p[i, :c], o_f[i, :c], atol=2e-6)
        np.testing.assert_array_equal(
            pinned.last_sample_indices[i], full.last_sample_indices[i]
        )
    # the pin really bounds the staged shapes: only the 8-hop buffer
    assert len(pinned._stage) == 1


def test_bank_bucket_ladder_validation(sample_config):
    for bad in ((), (0,), (32, 8), (8, 8)):
        with pytest.raises(ValueError, match="buckets"):
            DetectorBank([sample_config], buckets=bad)
    with pytest.raises(ValueError, match="transfer_dtype"):
        DetectorBank([sample_config], transfer_dtype="int8")


def test_bank_int16_wire_semantics(sample_config):
    """The int16 wire must equal a float bank fed the PRE-QUANTIZED
    stream (clip to [-1,1], round to 1/32767 steps) — the exact
    precision of S16 capture hardware. An int16-sourced stream therefore
    roundtrips exactly."""
    rng = np.random.default_rng(31)
    audio = make_audio(rng, seconds=0.5) * 1.1  # exercise the clip too
    cfgs = [sample_config, _perturbed_cfg(sample_config, 9)]

    wire = DetectorBank(cfgs, transfer_dtype="int16")
    oracle = DetectorBank(cfgs)
    q = np.rint(np.clip(audio, -1.0, 1.0) * np.float32(32767.0))
    dq = (q * np.float32(1.0 / 32767.0)).astype(np.float32)
    for i in range(2):
        wire.append_audio_data(i, audio)
        oracle.append_audio_data(i, dq)
    o_w = wire.drain()
    o_o = oracle.drain()
    np.testing.assert_array_equal(wire.last_counts, oracle.last_counts)
    for i in range(2):
        c = oracle.last_counts[i]
        np.testing.assert_array_equal(o_w[i, :c], o_o[i, :c])

    # int16-sourced stream: the wire is EXACT vs the float path fed the
    # same dequantized samples (quantize o dequantize == identity there)
    src = (q * np.float32(1.0 / 32767.0)).astype(np.float32)
    w2 = DetectorBank(cfgs, transfer_dtype="int16")
    f2 = DetectorBank(cfgs)
    for i in range(2):
        w2.append_audio_data(i, src)
        f2.append_audio_data(i, src)
    np.testing.assert_array_equal(w2.drain(), f2.drain())


def test_bank_int16_wire_warm_up(sample_config):
    bank = DetectorBank([sample_config], transfer_dtype="int16", buckets=(8, 32))
    assert bank.warm_up() == 2


def test_bank_min_drain_hops_defers_tails(sample_config):
    """min_drain_hops leaves sub-threshold tails buffered (bounding the
    per-round transfer overhead) — but a CLOSED front segment drains
    regardless, since its hop count can never grow and post-gap audio
    queues behind it. flush=True evaluates everything."""
    spec_hop, t = 132, 10  # sample net geometry (hop, time_range)
    bank = DetectorBank([sample_config], min_drain_hops=64)
    rng = np.random.default_rng(41)
    audio = make_audio(rng, seconds=2.0)

    # 20 hops available: below the floor -> deferred
    n20 = (20 + t - 1) * spec_hop + 124  # 20 evaluable hops
    bank.append_audio_data(0, audio[:n20])
    assert bank.drain().shape[1] == 0
    assert bank.last_counts[0] == 0

    # grow past the floor -> drains everything available
    bank.append_audio_data(0, audio[n20 : n20 + 64 * spec_hop])
    bank.drain()
    assert bank.last_counts[0] >= 64

    # closed front segment: a gap closes it; its 10-hop tail must drain
    # even though 10 < min_drain_hops (avail can never grow)
    n10 = (10 + t - 1) * spec_hop + 124
    b2 = DetectorBank([sample_config], min_drain_hops=64)
    b2.append_audio_data(0, audio[:n10])
    b2.note_gap(0, 5000)
    b2.append_audio_data(0, audio[:500])  # post-gap audio queues behind
    b2.drain()
    assert b2.last_counts[0] == 10

    # flush=True ignores the floor
    b3 = DetectorBank([sample_config], min_drain_hops=64)
    b3.append_audio_data(0, audio[:n20])
    b3.drain(flush=True)
    assert b3.last_counts[0] == 20

    # deferred tails are NOT lost: outputs across the two drains equal a
    # floor-less bank fed the same stream
    b4 = DetectorBank([sample_config], min_drain_hops=64)
    free = DetectorBank([sample_config])
    for b in (b4, free):
        b.append_audio_data(0, audio[:n20])
    o_free1 = free.drain()[0, : free.last_counts[0]]
    b4.drain()
    for b in (b4, free):
        b.append_audio_data(0, audio[n20:40000])
    got = b4.drain()[0, : b4.last_counts[0]]
    o_free2 = free.drain()[0, : free.last_counts[0]]
    want = np.concatenate([o_free1, o_free2])
    assert len(got) == len(want)


def test_mulaw_companding_properties():
    """The mu-law code pair: exact zero, odd symmetry, monotone, and the
    documented error envelope (<=3.5e-4 absolute near zero — the mu-law
    half-step compounded with the int16 pre-quantization — and <=2.3%
    of |x| + that floor across the range: ~ln(256)/254 relative, the
    127-level continuous-mu-law half step)."""
    from syllable_detector_tpu.models.detector_bank import (
        _mulaw_lut,
        mulaw_expand_np,
    )

    lut = _mulaw_lut()
    assert lut.dtype == np.int8 and len(lut) == 65536
    assert lut[32768] == 0 and mulaw_expand_np(np.zeros(1, np.int8))[0] == 0
    # odd symmetry over the symmetric code range
    assert np.array_equal(lut[32768 + 1 :], -lut[32768 - 1 : 0 : -1][: 32767])
    # monotone non-decreasing codes
    assert np.all(np.diff(lut.astype(np.int16)) >= 0)

    x = np.linspace(-1.0, 1.0, 20001).astype(np.float32)
    q = np.rint(np.clip(x, -1, 1) * np.float32(32767.0)).astype(np.int32)
    rt = mulaw_expand_np(lut[q + 32768])
    err = np.abs(rt - x)
    assert err[np.abs(x) < 0.01].max() < 3.5e-4
    assert np.all(err <= 0.023 * np.abs(x) + 3.5e-4)


def test_bank_mulaw8_wire_semantics(sample_config):
    """The mulaw8 wire must EXACTLY equal a float bank fed the
    companding-roundtripped stream (encode via the LUT, expand via the
    reference numpy expansion) — the tier's loss is fully characterized
    by that roundtrip, with no additional wire error."""
    from syllable_detector_tpu.models.detector_bank import (
        _mulaw_lut,
        mulaw_expand_np,
    )

    rng = np.random.default_rng(33)
    audio = make_audio(rng, seconds=0.5) * 1.1
    cfgs = [sample_config, _perturbed_cfg(sample_config, 9)]

    wire = DetectorBank(cfgs, transfer_dtype="mulaw8")
    oracle = DetectorBank(cfgs)
    q = np.rint(np.clip(audio, -1.0, 1.0) * np.float32(32767.0)).astype(
        np.int32
    )
    rt = mulaw_expand_np(_mulaw_lut()[q + 32768])
    for i in range(2):
        wire.append_audio_data(i, audio)
        oracle.append_audio_data(i, rt)
    o_w = wire.drain()
    o_o = oracle.drain()
    np.testing.assert_array_equal(wire.last_counts, oracle.last_counts)
    for i in range(2):
        c = oracle.last_counts[i]
        np.testing.assert_allclose(o_w[i, :c], o_o[i, :c], atol=1e-6)

    # end-to-end tier fidelity on detector OUTPUTS vs the float32 wire:
    # bounded and small on representative audio (opt-in tier contract)
    f = DetectorBank(cfgs)
    for i in range(2):
        f.append_audio_data(i, audio)
    o_f = f.drain()
    c = min(int(f.last_counts.min()), int(wire.last_counts.min()))
    assert c > 0
    assert np.max(np.abs(o_w[:, :c] - o_f[:, :c])) < 0.02


def test_bank_mulaw8_wire_warm_up(sample_config):
    bank = DetectorBank(
        [sample_config], transfer_dtype="mulaw8", buckets=(8, 32)
    )
    assert bank.warm_up() == 2


@pytest.mark.parametrize("wire", ["float32", "int16", "mulaw8"])
def test_bank_native_staging_bit_identical(sample_config, wire):
    """The native drain stager (sdstage_batch: one C call per round —
    the numpy loop's ~6 dispatches/lane were the worker-side host wall
    at high lane counts) must stage BIT-IDENTICAL wire buffers to the
    numpy fallback under adversarial lifecycles: uneven lane fills, a
    mid-stream gap, clipping samples, and shrinking fills that exercise
    the stale-tail re-zero."""
    from syllable_detector_tpu.runtime.ring_buffer import DrainStager

    if not DrainStager(1).available:
        pytest.skip("native staging library unavailable")

    cfgs = [_perturbed_cfg(sample_config, i) for i in range(5)]
    banks = []
    for native in (True, False):
        b = DetectorBank(cfgs, buckets=(8, 32), transfer_dtype=wire)
        if native:
            assert b._stager is not None
        else:
            b._stager = None
        staged = []

        def wo(xs, staged=staged, b=b):
            staged.append(xs.copy())
            return np.zeros(
                (len(cfgs), xs.shape[1], b.spec.net.outputs), np.float32
            )

        b._wire_outputs = wo
        b.staged = staged
        banks.append(b)

    lane_lens = [5000, 3000, 0, 9000, 700]
    for r in range(4):
        for b in banks:
            for i in range(5):
                if r == 2 and i == 3:
                    b.note_gap(i, 100)
                rng = np.random.default_rng(r * 10 + i)
                x = rng.standard_normal(lane_lens[i] + r * 1311).astype(
                    np.float32
                ) * (1.5 if i == 1 else 0.3)  # lane 1 exercises the clip
                b.append_audio_data(i, x)
            b.drain()
    a, c = banks[0].staged, banks[1].staged
    assert len(a) == len(c) and len(a) >= 8  # multi-round bucket ladder
    for u, v in zip(a, c):
        assert u.dtype == v.dtype and u.shape == v.shape
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("wire", ["float32", "int16", "mulaw8"])
def test_bank_one_program_drain_matches_eager(sample_config, wire):
    """The one-program drain (on-device dequantization + the vmapped
    pipeline in a single jit) must match independent Detectors fed the
    host-side wire round trip, under uneven fills and a gap."""
    from syllable_detector_tpu.models.detector_bank import (
        _mulaw_lut,
        mulaw_expand_np,
    )

    def wire_roundtrip(x):
        if wire == "float32":
            return x
        q = np.rint(np.clip(x, -1.0, 1.0) * np.float32(32767.0))
        if wire == "int16":
            return (q / np.float32(32767.0)).astype(np.float32)
        return mulaw_expand_np(_mulaw_lut()[q.astype(np.int32) + 32768])

    cfgs = [_perturbed_cfg(sample_config, i) for i in range(3)]
    rng = np.random.default_rng(77)
    streams = [make_audio(rng, seconds=0.4 + 0.1 * i) * 1.2 for i in range(3)]
    bank = DetectorBank(cfgs, transfer_dtype=wire, buckets=(8, 32))
    singles = [Detector(c) for c in cfgs]
    got = [[] for _ in cfgs]
    want = [[] for _ in cfgs]
    for r in range(3):
        for i, s in enumerate(streams):
            if r == 1 and i == 2:
                bank.note_gap(i, 500)
                want[i].append(singles[i].drain())
                singles[i].note_gap(500)
            chunk = s[r * len(s) // 4 : (r + 1) * len(s) // 4]
            bank.append_audio_data(i, chunk)
            singles[i].append_audio_data(wire_roundtrip(chunk))
        outs = bank.drain()
        for i in range(3):
            got[i].append(outs[i, : bank.last_counts[i]])
    for i in range(3):
        want[i].append(singles[i].drain())
        g = np.concatenate(got[i])
        w = np.concatenate(want[i])
        # the single detectors drain every hop; the bank's last round can
        # leave none behind either (min_drain_hops=1)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=1e-4)


def test_bank_program_unfusable_falls_back(sample_config):
    """A chain the affine fold cannot express (``normalize``) still drains
    correctly: the bank's XLA program applies any input chain."""
    import dataclasses

    from syllable_detector_tpu.config.model_format import ProcessingSpec
    from syllable_detector_tpu.models.detector import (
        detector_spec_from_config,
        fusable,
    )

    cfg = dataclasses.replace(
        sample_config, process_inputs=[ProcessingSpec("normalize")]
    )
    spec, _ = detector_spec_from_config(cfg)
    assert not fusable(spec)
    bank = DetectorBank([cfg])
    single = Detector(cfg)
    audio = make_audio(np.random.default_rng(3), seconds=0.5)
    bank.append_audio_data(0, audio)
    single.append_audio_data(audio)
    got = bank.drain()[0, : bank.last_counts[0]]
    want = single.drain()
    np.testing.assert_allclose(got[:, 0], want[: len(got), 0], atol=1e-5)
