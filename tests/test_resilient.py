"""ResilientDetector: process-isolated detection survives a child crash
with exact output continuity (snapshot + journal replay)."""

import numpy as np
import pytest

from syllable_detector_tpu.models.detector import Detector
from syllable_detector_tpu.runtime.resilient import ResilientDetector
from test_detector import make_audio


def test_resilient_crash_recovery(sample_config):
    rng = np.random.default_rng(13)
    x = make_audio(rng, seconds=0.6)

    # oracle: uninterrupted in-process detector
    oracle = Detector(sample_config)
    want = []
    with ResilientDetector(sample_config, timeout=120.0) as r:
        got = []
        chunks = [x[i : i + 5000] for i in range(0, len(x), 5000)]
        for k, chunk in enumerate(chunks):
            oracle.append_audio_data(chunk)
            o = oracle.drain()
            if len(o):
                want.append(o)

            r.append_audio_data(chunk)
            if k == 2:
                # poison the runtime mid-stream: the child dies abruptly
                # WITH un-drained journal entries pending
                r.crash_for_test()
            o = r.drain()
            if o.shape[1]:
                got.append(o[0])
        assert r.restarts >= 1
        got = np.concatenate(got, axis=0)
        want = np.concatenate(want, axis=0)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)


def test_resilient_multi_lane_and_limit(sample_config):
    with ResilientDetector(
        [sample_config, sample_config], timeout=120.0, max_restarts=1
    ) as r:
        rng = np.random.default_rng(14)
        x = make_audio(rng, seconds=0.3)
        r.append_audio_data(x, lane=0)
        r.append_audio_data(x, lane=1)
        outs = r.drain()
        assert outs.shape[0] == 2 and outs.shape[1] > 0
        np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)

        # two crashes in a row exceed max_restarts=1 only if the restart
        # itself fails; one crash must recover fine
        r.crash_for_test()
        r.append_audio_data(x, lane=0)
        r.append_audio_data(x, lane=1)
        outs2 = r.drain()
        assert r.restarts == 1
        assert outs2.shape[0] == 2


def test_resilient_append_exactly_once_on_crash(sample_config):
    """A child death DURING an append must not double-apply the chunk:
    the restart's journal replay covers it and the request is not
    re-sent."""
    rng = np.random.default_rng(15)
    x = make_audio(rng, seconds=0.4)

    oracle = Detector(sample_config)
    oracle.append_audio_data(x[:8000])
    w1 = oracle.drain()
    oracle.append_audio_data(x[8000:])
    w2 = oracle.drain()
    want = np.concatenate([w1, w2])

    with ResilientDetector(sample_config, timeout=120.0) as r:
        r.append_audio_data(x[:8000])
        r.drain()
        # kill the child abruptly so the NEXT append request fails in
        # flight; the restart replays the journaled chunk exactly once
        r._proc.terminate()
        r._proc.join(timeout=10)
        r.append_audio_data(x[8000:])
        out2 = r.drain()
        assert r.restarts >= 1
        got = np.concatenate([w1, out2[0]])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)


def test_resilient_semantic_error_no_respawn(sample_config):
    """A deterministic child error (bad set_state) must surface
    IMMEDIATELY, not burn max_restarts full respawns (each a potential
    cold-compile): restarts stays 0 and the child keeps serving."""
    from syllable_detector_tpu.runtime.resilient import DetectorChildError

    rng = np.random.default_rng(17)
    x = make_audio(rng, seconds=0.2)
    with ResilientDetector(sample_config, timeout=120.0) as r:
        bad_state = {
            "segments": [[], []],  # 2 lanes into a 1-lane bank -> ValueError
            "offered": [0, 0],
            "hops_emitted": [0, 0],
            "last_outputs": np.zeros((2, 1), np.float32),
            "overflows": [0, 0],
            "dropped_samples": [0, 0],
        }
        with pytest.raises(DetectorChildError, match="lanes"):
            r._supervised(("set_state", bad_state))
        assert r.restarts == 0
        # the child is still alive and serving
        r.append_audio_data(x)
        out = r.drain()
        assert out.shape[1] > 0


def test_resilient_journal_gap_markers_bounded(sample_config):
    """Appends the child bank would drop at its cap are journaled as
    compact gap markers (no audio retained — ADVICE r3: unbounded journal
    growth), and a crash replay reproduces the bank's sample-accurate gap
    accounting exactly."""
    from syllable_detector_tpu.models.detector_bank import DetectorBank

    rng = np.random.default_rng(18)
    x1 = make_audio(rng, seconds=0.2)
    x2 = make_audio(rng, seconds=0.2)  # will be dropped at the 0.3 s cap
    x3 = make_audio(rng, seconds=0.2)

    oracle = DetectorBank([sample_config], max_buffer_seconds=0.3)
    oracle.append_audio_data(0, x1)
    assert not oracle.append_audio_data(0, x2)
    o1 = oracle.drain()
    c1 = int(oracle.last_counts[0])
    oracle.append_audio_data(0, x3)
    o2 = oracle.drain()
    c2 = int(oracle.last_counts[0])
    idx2 = oracle.last_sample_indices[0]

    with ResilientDetector(
        sample_config, timeout=120.0, max_buffer_seconds=0.3
    ) as r:
        r.append_audio_data(x1)
        r.append_audio_data(x2)  # beyond the mirror cap -> gap marker
        gap_entries = [e for e in r._journal if e[0] == "gap"]
        assert gap_entries == [("gap", 0, len(x2))]  # no audio retained
        g1 = r.drain()
        assert int(r.last_counts[0]) == c1
        np.testing.assert_allclose(
            g1[0, :c1], o1[0, :c1], rtol=1e-5, atol=1e-6
        )
        # crash AFTER the gap: the restart replays the post-snapshot
        # journal; gap accounting must survive into the timestamps
        r.crash_for_test()
        r.append_audio_data(x3)
        g2 = r.drain()
        assert r.restarts >= 1
        assert int(r.last_counts[0]) == c2
        np.testing.assert_allclose(
            g2[0, :c2], o2[0, :c2], rtol=1e-5, atol=1e-6
        )
        np.testing.assert_array_equal(r.last_sample_indices[0], idx2)


def test_resilient_warm_up_keeps_journal_consistent(sample_config):
    """append -> warm_up -> crash -> drain must not double-apply the
    pre-warm_up audio (warm_up's snapshot already contains it)."""
    rng = np.random.default_rng(16)
    x = make_audio(rng, seconds=0.3)
    oracle = Detector(sample_config)
    oracle.append_audio_data(x)
    want = oracle.drain()

    with ResilientDetector(sample_config, timeout=120.0) as r:
        r.append_audio_data(x)
        r.warm_up(buckets=(8,))
        r.crash_for_test()
        out = r.drain()
        assert r.restarts >= 1
    np.testing.assert_allclose(out[0], want, rtol=1e-3, atol=2e-4)


def test_resilient_init_handshake_failure_kills_child(sample_config, monkeypatch):
    """A failed/hung ready handshake must not LEAK the spawned child: the
    exception escapes __init__ (no instance -> close() can never run), so
    _start_child itself reaps the process — otherwise a daemon child
    holding the card starves every retry in this parent."""
    from syllable_detector_tpu.runtime import resilient as rmod

    killed = []
    orig_kill = rmod.ResilientDetector._kill_child

    def spy_kill(self):
        killed.append(self._proc)
        orig_kill(self)

    def bad_recv(self):
        raise TimeoutError("simulated hung handshake")

    monkeypatch.setattr(rmod.ResilientDetector, "_recv", bad_recv)
    monkeypatch.setattr(rmod.ResilientDetector, "_kill_child", spy_kill)

    with pytest.raises(TimeoutError):
        rmod.ResilientDetector(sample_config, timeout=5.0)

    assert killed, "constructor failure did not reap the child"
    proc = killed[0]
    assert proc is not None
    proc.join(timeout=10)
    assert not proc.is_alive()


def test_resilient_interleaved_api_with_gap_and_crash(sample_config):
    """Interleaved capture + an interleaved-stream gap through the
    resilient supervisor match DetectorBank semantics exactly — and the
    record survives a child crash (the parent-side de-interleave carry
    and journaled gap markers replay correctly)."""
    from syllable_detector_tpu.models.detector_bank import DetectorBank

    rng = np.random.default_rng(23)
    a = make_audio(rng, seconds=0.25)
    b = make_audio(rng, seconds=0.25)
    pre = np.empty(2 * len(a), np.float32)
    pre[0::2], pre[1::2] = a, b
    post = np.empty_like(pre)
    post[0::2], post[1::2] = b, a
    n_lost = 2 * 1500

    oracle = DetectorBank([sample_config, sample_config])
    oracle.append_interleaved_audio_data(pre[:-1])  # odd: carry pending
    oracle.drain()
    want_pre = (oracle.last_outputs.copy(),
                [i.copy() for i in oracle.last_sample_indices])
    oracle.note_interleaved_gap(n_lost)
    oracle.append_interleaved_audio_data(post)
    oracle.drain()

    with ResilientDetector(
        [sample_config, sample_config], timeout=120.0
    ) as r:
        r.append_interleaved_audio_data(pre[:-1])
        r.drain()
        for lane in range(2):
            np.testing.assert_array_equal(
                r.last_sample_indices[lane], want_pre[1][lane]
            )
        r.note_interleaved_gap(n_lost)
        r.crash_for_test()  # gap marker + carry must survive the respawn
        r.append_interleaved_audio_data(post)
        r.drain()
        assert r.restarts >= 1
        for lane in range(2):
            np.testing.assert_array_equal(
                r.last_sample_indices[lane],
                oracle.last_sample_indices[lane],
            )
