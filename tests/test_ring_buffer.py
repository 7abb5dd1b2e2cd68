"""Native + fallback ring buffer tests: wrap-around, SPSC threading, mirror."""

import threading

import numpy as np
import pytest

from syllable_detector_tpu.runtime.ring_buffer import RingBuffer, native_available


@pytest.fixture(params=["native", "python"])
def ring_kind(request):
    if request.param == "native" and not native_available():
        pytest.skip("native ring unavailable (no compiler)")
    return request.param == "python"


def test_native_builds():
    assert native_available(), "native ring buffer must build in this image"


def test_basic_produce_consume(ring_kind):
    r = RingBuffer(1024, force_python=ring_kind)
    x = np.arange(100, dtype=np.float32)
    assert r.produce(x)
    assert r.fill == 100
    got = r.peek()
    np.testing.assert_array_equal(got, x)
    r.consume(40)
    np.testing.assert_array_equal(r.peek(), x[40:])
    assert r.fill == 60


def test_reject_overflow(ring_kind):
    r = RingBuffer(64, force_python=ring_kind)
    cap = r.capacity
    assert r.produce(np.zeros(cap, np.float32))
    assert not r.produce(np.ones(1, np.float32))
    r.consume(1)
    assert r.produce(np.ones(1, np.float32))


def test_wraparound_many_times(ring_kind):
    r = RingBuffer(256, force_python=ring_kind)
    cap = r.capacity
    written = 0
    read = 0
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(1, cap // 2))
        chunk = np.arange(written, written + n, dtype=np.float32)
        if r.produce(chunk):
            written += n
        m = int(rng.integers(0, r.fill + 1))
        if m:
            got = r.peek(m)
            np.testing.assert_array_equal(got, np.arange(read, read + m, dtype=np.float32))
            r.consume(m)
            read += m
    assert written - read == r.fill


def test_clear(ring_kind):
    r = RingBuffer(128, force_python=ring_kind)
    r.produce(np.zeros(50, np.float32))
    r.clear()
    assert r.fill == 0
    assert r.produce(np.zeros(r.capacity, np.float32))


def test_spsc_threads(ring_kind):
    """One producer, one consumer, 1e6 samples, data must arrive in order."""
    r = RingBuffer(4096, force_python=ring_kind)
    total = 1_000_000
    errors = []

    def producer():
        sent = 0
        while sent < total:
            n = min(1000, total - sent)
            chunk = np.arange(sent, sent + n, dtype=np.float32)
            if r.produce(chunk):
                sent += n

    def consumer():
        seen = 0
        while seen < total:
            avail = r.fill
            if avail:
                got = r.peek(avail)
                expect = np.arange(seen, seen + len(got), dtype=np.float32)
                if not np.array_equal(got, expect):
                    errors.append((seen, got[:5], expect[:5]))
                    return
                r.consume(len(got))
                seen += len(got)

    # daemon threads: a corruption failure must surface as a clean assert,
    # not as an orphaned busy-loop thread hanging pytest shutdown
    t1 = threading.Thread(target=producer, daemon=True)
    t2 = threading.Thread(target=consumer, daemon=True)
    t1.start(); t2.start()
    t1.join(timeout=60); t2.join(timeout=60)
    assert not errors, errors
    assert not t1.is_alive() and not t2.is_alive()
    assert r.fill == 0


def test_ensure_native_library_contract(tmp_path):
    """Shared build helper (utils.native_build): builds into a library
    keyed on the source (same source -> same library, reused; edited
    source -> a fresh build, never the stale one), via a temp name +
    atomic rename, removes the temp on compile failure, and raises with
    compiler stderr attached."""
    import ctypes
    import os

    import pytest

    from syllable_detector_tpu.utils.native_build import (
        NativeBuildError,
        ensure_native_library,
    )

    # success: a trivial translation unit builds and loads
    src = tmp_path / "ok.cpp"
    src.write_text('extern "C" int answer() { return 42; }\n')
    out = ensure_native_library(str(src))
    assert os.path.dirname(out) == str(tmp_path / "build")
    assert ctypes.CDLL(out).answer() == 42
    # same source: the existing build is reused, not rebuilt
    stamp = os.stat(out).st_mtime_ns
    assert ensure_native_library(str(src)) == out
    assert os.stat(out).st_mtime_ns == stamp
    # edited source: a new library, built from the new text
    src.write_text('extern "C" int answer() { return 7; }\n')
    out2 = ensure_native_library(str(src))
    assert out2 != out
    assert ctypes.CDLL(out2).answer() == 7

    # missing source
    with pytest.raises(NativeBuildError, match="not found"):
        ensure_native_library(str(tmp_path / "nope.cpp"))

    # compile failure: stderr captured, no temp file left behind
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(NativeBuildError) as ei:
        ensure_native_library(str(bad))
    assert ei.value.stderr  # compiler diagnostics attached
    leftovers = [
        p.name for p in (tmp_path / "build").iterdir() if ".tmp" in p.name
    ]
    assert leftovers == []


def test_ring_block_writer_matches_per_ring():
    """One native produce call == per-ring produce: same content, same
    per-ring full/drop behavior, Python-fallback parity."""
    import numpy as np

    from syllable_detector_tpu.runtime.ring_buffer import (
        RingBlockWriter,
        RingBuffer,
    )

    for force_python in (False, True):
        rings = [RingBuffer(64, force_python=force_python) for _ in range(3)]
        w = RingBlockWriter(rings)
        block = np.arange(3 * 32, dtype=np.float32).reshape(3, 32)
        ok = w.produce(block)
        assert ok.tolist() == [True, True, True]
        for i, r in enumerate(rings):
            np.testing.assert_array_equal(r.peek(), block[i])
        # fill ring 1 so its next row drops; the others still succeed
        assert rings[1].produce(np.zeros(rings[1].capacity - 32, np.float32))
        ok = w.produce(block + 100)
        assert ok.tolist() == [True, False, True]
        rings[0].consume(32)
        np.testing.assert_array_equal(rings[0].peek()[:32], block[0] + 100)
        with np.testing.assert_raises(Exception):
            w.produce(np.zeros((2, 8), np.float32))  # row-count mismatch
