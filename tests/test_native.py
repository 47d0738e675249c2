"""Native runtime (C++ ring buffer + codec loops) tests."""

import threading

import numpy as np

from projectultra import native
from projectultra.protocol.frame_v2 import crc16_ccitt


def test_native_builds():
    assert native.available(), "g++ is in the image; native lib must build"


def test_crc16_matches_python():
    for data in (b"", b"\x01\x02\x03\x04\x05", bytes(range(256)) * 3):
        assert native.crc16(data) == crc16_ccitt(data)


def test_crc32_matches_zlib():
    import zlib
    data = bytes(range(256)) * 10
    assert native.crc32(data) == zlib.crc32(data) & 0xFFFFFFFF


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
    bits = native.unpack_bits(data)
    np.testing.assert_array_equal(bits, np.unpackbits(
        np.frombuffer(data, np.uint8)))
    assert native.pack_bits(bits) == data


def test_ring_buffer_basic():
    rb = native.RingBuffer(1 << 12)
    x = np.arange(1000, dtype=np.float32)
    assert rb.write(x) == 1000
    assert rb.available() == 1000
    np.testing.assert_array_equal(rb.peek(10), x[:10])
    np.testing.assert_array_equal(rb.read(600), x[:600])
    assert rb.available() == 400
    assert rb.skip(100) == 100
    np.testing.assert_array_equal(rb.read(300), x[700:])


def test_ring_buffer_wraparound_and_threads():
    """SPSC across threads: producer writes 20ms chunks, consumer drains."""
    rb = native.RingBuffer(1 << 14)
    total = 200_000
    src = np.random.default_rng(1).standard_normal(total).astype(np.float32)
    out = []

    def producer():
        i = 0
        while i < total:
            n = rb.write(src[i:i + 960])
            i += n

    def consumer():
        got = 0
        while got < total:
            chunk = rb.read(4096)
            if len(chunk):
                out.append(chunk)
                got += len(chunk)

    tp = threading.Thread(target=producer, daemon=True)
    tc = threading.Thread(target=consumer, daemon=True)
    tp.start(); tc.start()
    # Bounded joins: a lost/duplicated sample (the SPSC bug this test
    # exists to catch) must FAIL, not wedge the suite in the spin loops.
    tp.join(timeout=30); tc.join(timeout=30)
    assert not tp.is_alive() and not tc.is_alive(), "ring transfer stalled"
    result = np.concatenate(out)
    np.testing.assert_array_equal(result, src)
