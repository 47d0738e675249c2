// Native host runtime for projectultra: the pieces the reference keeps
// in C++ around its DSP core (src/gui/modem/modem_rx.cpp ring buffer,
// src/protocol/frame_v2.cpp codec loops).  The device owns the math; this owns
// the host-side streaming/IO hot paths:
//
//   * lock-free SPSC ring buffer (audio thread -> acquisition thread handoff,
//     replacing the reference's mutex-guarded rx_sample_buffer_)
//   * CRC-16-CCITT / CRC-32 frame codec loops
//   * byte<->bit (un)packing and static-permutation interleaving
//
// Built as a plain C-ABI shared library; Python binds via ctypes (pybind11
// is not available in this image).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdlib>

extern "C" {

// ---------------------------------------------------------------------------
// CRC-16-CCITT, poly 0x1021, init 0xFFFF (frame_v2.cpp:111-125)
// ---------------------------------------------------------------------------

uint16_t ultra_crc16(const uint8_t* data, size_t len) {
    uint16_t crc = 0xFFFF;
    for (size_t i = 0; i < len; ++i) {
        crc = static_cast<uint16_t>(crc ^ (static_cast<uint16_t>(data[i]) << 8));
        for (int j = 0; j < 8; ++j) {
            crc = (crc & 0x8000) ? static_cast<uint16_t>((crc << 1) ^ 0x1021)
                                 : static_cast<uint16_t>(crc << 1);
        }
    }
    return crc;
}

// CRC-32 (zlib polynomial), table-driven (file_transfer.cpp:40-64)
static uint32_t g_crc32_table[256];
static std::atomic<bool> g_crc32_init{false};

static void crc32_init() {
    for (uint32_t i = 0; i < 256; ++i) {
        uint32_t c = i;
        for (int j = 0; j < 8; ++j)
            c = (c & 1) ? (0xEDB88320u ^ (c >> 1)) : (c >> 1);
        g_crc32_table[i] = c;
    }
    g_crc32_init.store(true, std::memory_order_release);
}

uint32_t ultra_crc32(const uint8_t* data, size_t len) {
    if (!g_crc32_init.load(std::memory_order_acquire)) crc32_init();
    uint32_t crc = 0xFFFFFFFFu;
    for (size_t i = 0; i < len; ++i)
        crc = g_crc32_table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
    return crc ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// Byte <-> bit packing (MSB first) and permutation interleaving
// ---------------------------------------------------------------------------

void ultra_unpack_bits(const uint8_t* bytes, size_t nbytes, uint8_t* bits) {
    for (size_t i = 0; i < nbytes; ++i) {
        uint8_t b = bytes[i];
        uint8_t* o = bits + i * 8;
        o[0] = (b >> 7) & 1; o[1] = (b >> 6) & 1; o[2] = (b >> 5) & 1;
        o[3] = (b >> 4) & 1; o[4] = (b >> 3) & 1; o[5] = (b >> 2) & 1;
        o[6] = (b >> 1) & 1; o[7] = b & 1;
    }
}

void ultra_pack_bits(const uint8_t* bits, size_t nbits, uint8_t* bytes) {
    size_t nbytes = (nbits + 7) / 8;
    std::memset(bytes, 0, nbytes);
    for (size_t i = 0; i < nbits; ++i)
        if (bits[i]) bytes[i / 8] |= static_cast<uint8_t>(1u << (7 - (i % 8)));
}

// out[perm[i]] = in[i] (interleave); use the inverse permutation to
// deinterleave.  Works for bit arrays and float32 LLR arrays.
void ultra_permute_u8(const uint8_t* in, const int32_t* perm, size_t n,
                      uint8_t* out) {
    for (size_t i = 0; i < n; ++i) out[perm[i]] = in[i];
}

void ultra_permute_f32(const float* in, const int32_t* perm, size_t n,
                       float* out) {
    for (size_t i = 0; i < n; ++i) out[perm[i]] = in[i];
}

// ---------------------------------------------------------------------------
// Lock-free SPSC float ring buffer (modem_rx.cpp:262-350 equivalent).
// One producer (audio callback) and one consumer (acquisition loop);
// capacity is rounded up to a power of two.
// ---------------------------------------------------------------------------

struct UltraRing {
    float* data;
    size_t capacity;   // power of two
    size_t mask;
    std::atomic<uint64_t> head;  // write index (producer)
    std::atomic<uint64_t> tail;  // read index (consumer)
};

UltraRing* ultra_ring_create(size_t min_capacity) {
    size_t cap = 1;
    while (cap < min_capacity) cap <<= 1;
    auto* r = static_cast<UltraRing*>(std::malloc(sizeof(UltraRing)));
    if (!r) return nullptr;
    r->data = static_cast<float*>(std::malloc(cap * sizeof(float)));
    if (!r->data) { std::free(r); return nullptr; }
    r->capacity = cap;
    r->mask = cap - 1;
    r->head.store(0, std::memory_order_relaxed);
    r->tail.store(0, std::memory_order_relaxed);
    return r;
}

void ultra_ring_destroy(UltraRing* r) {
    if (r) { std::free(r->data); std::free(r); }
}

size_t ultra_ring_available(const UltraRing* r) {
    return static_cast<size_t>(r->head.load(std::memory_order_acquire)
                               - r->tail.load(std::memory_order_acquire));
}

size_t ultra_ring_space(const UltraRing* r) {
    return r->capacity - ultra_ring_available(r);
}

// Returns samples actually written (may be < n if full).
size_t ultra_ring_write(UltraRing* r, const float* samples, size_t n) {
    uint64_t head = r->head.load(std::memory_order_relaxed);
    uint64_t tail = r->tail.load(std::memory_order_acquire);
    size_t space = r->capacity - static_cast<size_t>(head - tail);
    if (n > space) n = space;
    for (size_t i = 0; i < n; ++i)
        r->data[(head + i) & r->mask] = samples[i];
    r->head.store(head + n, std::memory_order_release);
    return n;
}

// Pops up to n samples into out; returns count.
size_t ultra_ring_read(UltraRing* r, float* out, size_t n) {
    uint64_t tail = r->tail.load(std::memory_order_relaxed);
    uint64_t head = r->head.load(std::memory_order_acquire);
    size_t avail = static_cast<size_t>(head - tail);
    if (n > avail) n = avail;
    for (size_t i = 0; i < n; ++i)
        out[i] = r->data[(tail + i) & r->mask];
    r->tail.store(tail + n, std::memory_order_release);
    return n;
}

// Peek without consuming (acquisition snapshots, getBufferSnapshot).
size_t ultra_ring_peek(const UltraRing* r, float* out, size_t n) {
    uint64_t tail = r->tail.load(std::memory_order_acquire);
    uint64_t head = r->head.load(std::memory_order_acquire);
    size_t avail = static_cast<size_t>(head - tail);
    if (n > avail) n = avail;
    for (size_t i = 0; i < n; ++i)
        out[i] = r->data[(tail + i) & r->mask];
    return n;
}

// Drop n samples (consumeSamples).
size_t ultra_ring_skip(UltraRing* r, size_t n) {
    uint64_t tail = r->tail.load(std::memory_order_relaxed);
    uint64_t head = r->head.load(std::memory_order_acquire);
    size_t avail = static_cast<size_t>(head - tail);
    if (n > avail) n = avail;
    r->tail.store(tail + n, std::memory_order_release);
    return n;
}

// ---------------------------------------------------------------------------
// Streaming cascaded-biquad IIR (direct form II transposed), in-place.
// The adaptive narrowband exciser (modem/excision.py) runs its notch
// cascade here: per-sample IIR recurrences are the one RX hot-path the
// array backends can't batch (state carries across every sample and chunk
// boundary), exactly the runtime/IO layer this library exists for.
// coef: nsec x 5 doubles [b0, b1, b2, a1, a2] (a0 pre-normalized to 1);
// state: nsec x 2 doubles, carried across calls by the owner.
// ---------------------------------------------------------------------------

void ultra_biquad_cascade(float* data, size_t n, const double* coef,
                          double* state, int32_t nsec) {
    for (int32_t s = 0; s < nsec; ++s) {
        const double b0 = coef[s * 5 + 0], b1 = coef[s * 5 + 1],
                     b2 = coef[s * 5 + 2], a1 = coef[s * 5 + 3],
                     a2 = coef[s * 5 + 4];
        double z1 = state[s * 2], z2 = state[s * 2 + 1];
        for (size_t i = 0; i < n; ++i) {
            const double x = static_cast<double>(data[i]);
            const double y = b0 * x + z1;
            z1 = b1 * x - a1 * y + z2;
            z2 = b2 * x - a2 * y;
            data[i] = static_cast<float>(y);
        }
        state[s * 2] = z1;
        state[s * 2 + 1] = z2;
    }
}

}  // extern "C"
