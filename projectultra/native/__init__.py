"""ctypes bindings for the native host runtime (ultra_native.cpp).

Compiles the shared library on first use (g++ -O3 -shared) into
``.native_build`` at the root of the checkout (listed in ``.gitignore``);
every entry point has a pure-Python fallback so the package works without a
toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "ultra_native.cpp")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".native_build")
_LIB = None


def _build_lib() -> str | None:
    try:
        with open(_SRC, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        os.makedirs(_BUILD_DIR, exist_ok=True)
        out = os.path.join(_BUILD_DIR, f"ultra_native_{digest}.so")
        if not os.path.exists(out):
            tmp = out + f".tmp{os.getpid()}"
            subprocess.run(
                ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
                 "-fPIC", _SRC, "-o", tmp],
                check=True, capture_output=True)
            os.replace(tmp, out)
        return out
    except Exception:
        return None


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    path = _build_lib()
    if path is None:
        _LIB = False
        return False
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        _LIB = False
        return False
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.ultra_crc16.restype = ctypes.c_uint16
    lib.ultra_crc16.argtypes = [u8p, ctypes.c_size_t]
    lib.ultra_crc32.restype = ctypes.c_uint32
    lib.ultra_crc32.argtypes = [u8p, ctypes.c_size_t]
    lib.ultra_unpack_bits.argtypes = [u8p, ctypes.c_size_t, u8p]
    lib.ultra_pack_bits.argtypes = [u8p, ctypes.c_size_t, u8p]
    lib.ultra_permute_u8.argtypes = [u8p, i32p, ctypes.c_size_t, u8p]
    lib.ultra_permute_f32.argtypes = [f32p, i32p, ctypes.c_size_t, f32p]
    lib.ultra_ring_create.restype = ctypes.c_void_p
    lib.ultra_ring_create.argtypes = [ctypes.c_size_t]
    lib.ultra_ring_destroy.argtypes = [ctypes.c_void_p]
    for fn in ("ultra_ring_available", "ultra_ring_space", "ultra_ring_skip"):
        getattr(lib, fn).restype = ctypes.c_size_t
    lib.ultra_ring_available.argtypes = [ctypes.c_void_p]
    lib.ultra_ring_space.argtypes = [ctypes.c_void_p]
    lib.ultra_ring_skip.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    for fn in ("ultra_ring_write", "ultra_ring_read", "ultra_ring_peek"):
        getattr(lib, fn).restype = ctypes.c_size_t
        getattr(lib, fn).argtypes = [ctypes.c_void_p, f32p, ctypes.c_size_t]
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.ultra_biquad_cascade.argtypes = [f32p, ctypes.c_size_t, f64p, f64p,
                                         ctypes.c_int32]
    _LIB = lib
    return lib


def available() -> bool:
    return bool(_load())


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def crc16(data: bytes) -> int:
    lib = _load()
    if not lib:
        from ..protocol.frame_v2 import crc16_ccitt
        return crc16_ccitt(data)
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    return int(lib.ultra_crc16(_u8(buf), len(buf)))


def crc32(data: bytes) -> int:
    lib = _load()
    if not lib:
        import zlib
        return zlib.crc32(data) & 0xFFFFFFFF
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    return int(lib.ultra_crc32(_u8(buf), len(buf)))


def unpack_bits(data: bytes) -> np.ndarray:
    lib = _load()
    if not lib:
        return np.unpackbits(np.frombuffer(bytes(data), dtype=np.uint8))
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    out = np.empty(len(buf) * 8, np.uint8)
    lib.ultra_unpack_bits(_u8(buf), len(buf), _u8(out))
    return out


def pack_bits(bits: np.ndarray) -> bytes:
    lib = _load()
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    if not lib:
        return np.packbits(bits).tobytes()
    out = np.zeros((len(bits) + 7) // 8, np.uint8)
    lib.ultra_pack_bits(_u8(bits), len(bits), _u8(out))
    return out.tobytes()


class RingBuffer:
    """Lock-free SPSC float ring buffer (native; numpy fallback)."""

    def __init__(self, capacity: int = 1 << 20):
        self._lib = _load()
        if self._lib:
            self._ptr = self._lib.ultra_ring_create(capacity)
            self._fallback = None
        else:
            self._ptr = None
            self._fallback = np.zeros(0, np.float32)
        self.capacity = capacity

    def __del__(self):
        if getattr(self, "_lib", None) and getattr(self, "_ptr", None):
            self._lib.ultra_ring_destroy(self._ptr)
            self._ptr = None

    def write(self, samples: np.ndarray) -> int:
        samples = np.ascontiguousarray(samples, dtype=np.float32)
        if self._lib:
            return int(self._lib.ultra_ring_write(
                self._ptr, samples.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_float)), len(samples)))
        # Honor capacity like the native SPSC ring: truncate and report the
        # partial count so callers' backpressure (AudioEngine drop-oldest)
        # behaves identically on both backends.
        room = self.capacity - len(self._fallback)
        take = max(0, min(room, len(samples)))
        if take:
            self._fallback = np.concatenate([self._fallback, samples[:take]])
        return take

    def available(self) -> int:
        if self._lib:
            return int(self._lib.ultra_ring_available(self._ptr))
        return len(self._fallback)

    def peek(self, n: int) -> np.ndarray:
        if self._lib:
            out = np.empty(n, np.float32)
            got = int(self._lib.ultra_ring_peek(
                self._ptr, out.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_float)), n))
            return out[:got]
        return self._fallback[:n].copy()

    def read(self, n: int) -> np.ndarray:
        if self._lib:
            out = np.empty(n, np.float32)
            got = int(self._lib.ultra_ring_read(
                self._ptr, out.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_float)), n))
            return out[:got]
        out = self._fallback[:n].copy()
        self._fallback = self._fallback[len(out):]
        return out

    def skip(self, n: int) -> int:
        if self._lib:
            return int(self._lib.ultra_ring_skip(self._ptr, n))
        m = min(n, len(self._fallback))
        self._fallback = self._fallback[m:]
        return m


def biquad_cascade(data: np.ndarray, coef: np.ndarray,
                   state: np.ndarray) -> np.ndarray:
    """Streaming cascaded-biquad IIR, direct form II transposed.

    data: float32 [n] (returned filtered, input untouched); coef: float64
    [nsec, 5] rows [b0, b1, b2, a1, a2] with a0 normalized to 1; state:
    float64 [nsec, 2], MUTATED in place (carries across chunk boundaries).
    Native C loop when available (per-sample IIR recurrences don't batch);
    pure-Python fallback otherwise.
    """
    lib = _load()
    out = np.ascontiguousarray(data, np.float32).copy()
    coef = np.ascontiguousarray(coef, np.float64)
    assert state.dtype == np.float64 and state.flags.c_contiguous
    nsec = coef.shape[0]
    if lib:
        lib.ultra_biquad_cascade(
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(out),
            coef.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            state.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), nsec)
        return out
    x = out.astype(np.float64)
    for s in range(nsec):
        b0, b1, b2, a1, a2 = coef[s]
        z1, z2 = state[s]
        y = np.empty_like(x)
        for i in range(len(x)):
            yi = b0 * x[i] + z1
            z1 = b1 * x[i] - a1 * yi + z2
            z2 = b2 * x[i] - a2 * yi
            y[i] = yi
        state[s, 0], state[s, 1] = z1, z2
        x = y
    return x.astype(np.float32)
