// Lock-free single-producer/single-consumer byte ring buffer with
// virtual-memory mirroring.
//
// Linux runtime equivalent of the reference's TPCircularBuffer
// (reference: Common/TPCircularBuffer/TPCircularBuffer.c:43-136,
// TPCircularBuffer.h:53-189): the reference maps the buffer twice in
// contiguous virtual address space with mach vm_remap so reads and writes
// never wrap; this implementation does the same on Linux with
// memfd_create + two MAP_FIXED mmaps of one shared page range. The fill
// count is a C++11 atomic with acquire/release ordering, mirroring the
// reference's OSAtomic barriers (TPCircularBuffer.h:118, 159). Thread-safe
// for exactly one producer thread and one consumer thread, like the
// reference's contract (TPCircularBuffer.h:14).
//
// Exposed as a small C ABI for ctypes binding from Python.

#include <atomic>
#include <cstdint>
#include <cstring>

#include <sys/mman.h>
#include <unistd.h>

#ifndef MFD_CLOEXEC
#define MFD_CLOEXEC 0x0001U
#endif

extern "C" {

struct sdring {
    char* buffer;
    int32_t length;
    int32_t head;  // producer-owned offset
    int32_t tail;  // consumer-owned offset
    std::atomic<int32_t> fill;
};

// Create a ring with at least `min_capacity` bytes (rounded up to a page
// multiple). Returns nullptr on failure. Retries the mapping dance like the
// reference's 3-try loop (TPCircularBuffer.c:45-115).
sdring* sdring_create(int32_t min_capacity) {
    if (min_capacity <= 0) return nullptr;
    const long page = sysconf(_SC_PAGESIZE);
    const size_t cap = ((static_cast<size_t>(min_capacity) + page - 1) / page) * page;
    // page rounding near INT32_MAX would overflow the int32 length field
    // into a negative capacity (silent head/tail corruption) — reject
    if (cap > static_cast<size_t>(INT32_MAX)) return nullptr;

    for (int attempt = 0; attempt < 3; ++attempt) {
        int fd = memfd_create("sdring", MFD_CLOEXEC);
        if (fd < 0) return nullptr;
        if (ftruncate(fd, static_cast<off_t>(cap)) != 0) {
            close(fd);
            continue;
        }
        // reserve 2*cap of contiguous address space
        void* base = mmap(nullptr, cap * 2, PROT_NONE,
                          MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
        if (base == MAP_FAILED) {
            close(fd);
            continue;
        }
        void* lo = mmap(base, cap, PROT_READ | PROT_WRITE,
                        MAP_SHARED | MAP_FIXED, fd, 0);
        void* hi = mmap(static_cast<char*>(base) + cap, cap,
                        PROT_READ | PROT_WRITE, MAP_SHARED | MAP_FIXED, fd, 0);
        close(fd);  // mappings keep the memory alive
        if (lo == MAP_FAILED || hi == MAP_FAILED) {
            munmap(base, cap * 2);
            continue;
        }
        sdring* ring = new sdring();
        ring->buffer = static_cast<char*>(base);
        ring->length = static_cast<int32_t>(cap);
        ring->head = 0;
        ring->tail = 0;
        ring->fill.store(0, std::memory_order_relaxed);
        return ring;
    }
    return nullptr;
}

void sdring_destroy(sdring* ring) {
    if (!ring) return;
    munmap(ring->buffer, static_cast<size_t>(ring->length) * 2);
    delete ring;
}

int32_t sdring_capacity(const sdring* ring) { return ring->length; }

int32_t sdring_fill(const sdring* ring) {
    return ring->fill.load(std::memory_order_acquire);
}

// Producer side: pointer to writable space (never wraps, thanks to the
// mirror) and the number of bytes available (TPCircularBuffer.h:127-141).
void* sdring_head(sdring* ring, int32_t* available) {
    int32_t fill = ring->fill.load(std::memory_order_acquire);
    if (available) *available = ring->length - fill;
    return ring->buffer + ring->head;
}

void sdring_produce(sdring* ring, int32_t amount) {
    ring->head = (ring->head + amount) % ring->length;
    ring->fill.fetch_add(amount, std::memory_order_release);
}

// Copy `len` bytes in; returns 1 on success, 0 if there is not enough space
// (TPCircularBuffer.h:166-177).
int32_t sdring_produce_bytes(sdring* ring, const void* src, int32_t len) {
    int32_t space = 0;
    void* head = sdring_head(ring, &space);
    if (space < len) return 0;
    std::memcpy(head, src, static_cast<size_t>(len));
    sdring_produce(ring, len);
    return 1;
}

// Consumer side: pointer to readable bytes (contiguous via the mirror) and
// how many are available (TPCircularBuffer.h:81-96).
void* sdring_tail(sdring* ring, int32_t* available) {
    int32_t fill = ring->fill.load(std::memory_order_acquire);
    if (available) *available = fill;
    return ring->buffer + ring->tail;
}

void sdring_consume(sdring* ring, int32_t amount) {
    ring->tail = (ring->tail + amount) % ring->length;
    ring->fill.fetch_sub(amount, std::memory_order_release);
}

// Produce row i of a contiguous [count, row_bytes] block into rings[i] —
// ONE foreign call for a whole multi-channel capture block. ctypes call
// overhead (~5-7 us/call) otherwise dominates the per-lane fan-out cost
// at high channel counts. Per-ring success lands in ok_out (a full ring
// drops its row, like sdring_produce_bytes); returns how many succeeded.
int32_t sdring_produce_batch(sdring** rings, int32_t count,
                             const void* block, int32_t row_bytes,
                             uint8_t* ok_out) {
    const uint8_t* src = static_cast<const uint8_t*>(block);
    int32_t n_ok = 0;
    for (int32_t i = 0; i < count; ++i) {
        int32_t ok = sdring_produce_bytes(
            rings[i], src + static_cast<size_t>(i) * row_bytes, row_bytes);
        if (ok_out) ok_out[i] = static_cast<uint8_t>(ok);
        n_ok += ok;
    }
    return n_ok;
}

// Stage + quantize one DetectorBank drain round's [n_lanes, need] wire
// buffer in a single foreign call. The Python staging loop (per lane:
// clip copy, scale, rint, LUT gather, row store, stale-tail zero — ~6
// numpy dispatches each) measured 62% of this host's one core at 384
// lanes; this folds it into ONE pass per lane at memory speed.
//
// srcs[i]/lens[i]: lane i's consolidated float32 samples (lens[i] == 0
// for a lane with nothing to stage). xs: the [n_lanes, need] staging
// buffer of the wire dtype. prev[i]: how far row i was filled last
// round — only the stale tail [m, prev[i]) is re-zeroed (the same
// O(changed) contract as the Python path) — updated in place.
//
// mode 0 = float32 copy; mode 1 = int16 wire (clip to [-1,1], scale by
// 32767, round half-to-even — exactly numpy's clip/*=/rint staging, and
// exactly what S16 capture hardware does); mode 2 = mulaw8 (the int16
// code further companded through the caller's 64Ki int16->int8 LUT,
// indexed by code+32768). rintf under the default FE_TONEAREST mode ==
// np.rint (half-to-even). Non-finite samples are clipped to +-1 here
// while numpy propagates NaN into an undefined int cast — real capture
// paths never produce NaN, and clipping is the saner contract.
// Returns 0 on an unknown mode, else 1.
int32_t sdstage_batch(const float* const* srcs, const int64_t* lens,
                      int32_t n_lanes, void* xs, int64_t* prev,
                      int64_t need, int32_t mode, const int8_t* lut) {
    if (mode < 0 || mode > 2 || (mode == 2 && !lut)) return 0;
    for (int32_t i = 0; i < n_lanes; ++i) {
        int64_t m = lens[i] < need ? lens[i] : need;
        if (m < 0) m = 0;
        const float* src = srcs[i];
        if (mode == 0) {
            float* row = static_cast<float*>(xs) + static_cast<size_t>(i) * need;
            if (m) std::memcpy(row, src, static_cast<size_t>(m) * sizeof(float));
            for (int64_t k = m; k < prev[i]; ++k) row[k] = 0.0f;
        } else if (mode == 1) {
            int16_t* row =
                static_cast<int16_t*>(xs) + static_cast<size_t>(i) * need;
            for (int64_t k = 0; k < m; ++k) {
                float v = src[k];
                v = v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
                row[k] = static_cast<int16_t>(__builtin_rintf(v * 32767.0f));
            }
            for (int64_t k = m; k < prev[i]; ++k) row[k] = 0;
        } else {
            int8_t* row =
                static_cast<int8_t*>(xs) + static_cast<size_t>(i) * need;
            for (int64_t k = 0; k < m; ++k) {
                float v = src[k];
                v = v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
                row[k] =
                    lut[static_cast<int32_t>(__builtin_rintf(v * 32767.0f)) +
                        32768];
            }
            // mulaw code 0 is signal 0, so a zeroed tail stays correct
            for (int64_t k = m; k < prev[i]; ++k) row[k] = 0;
        }
        prev[i] = m;
    }
    return 1;
}

// Consumer-side reset (single-consumer contract; TPCircularBuffer.h:103-109).
void sdring_clear(sdring* ring) {
    int32_t fill = ring->fill.load(std::memory_order_acquire);
    if (fill > 0) sdring_consume(ring, fill);
}

}  // extern "C"
