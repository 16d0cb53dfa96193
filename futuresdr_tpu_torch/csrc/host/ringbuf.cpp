// Double-mapped circular buffer allocator + SPSC index arithmetic.
//
// The port's copy of the ring part of native/ringbuf.cpp, the native equivalent
// of the reference's `vmcircbuffer` crate (used by
// src/runtime/buffer/circular.rs): a memfd-backed region mapped twice back-to-back in
// virtual memory so that any window of up to `size` bytes starting at any offset is
// contiguous — readers/writers never see a wrap seam and work windows are never split.
//
// Exposed as a tiny C ABI bound from Python with ctypes.PyDLL
// (runtime/buffer/circular.py): every call is a few atomic loads and stores,
// so it keeps the interpreter lock rather than give it up and wait to take it
// back. Built with g++ on first use by ops/_build.py (load_host).

#ifndef _GNU_SOURCE
#define _GNU_SOURCE
#endif

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <sys/mman.h>
#include <unistd.h>

#ifndef MFD_CLOEXEC
#define MFD_CLOEXEC 0x0001U
#endif

extern "C" {

struct fsdr_dbuf {
    uint8_t *base;     // start of the first mapping; base[0 .. 2*size) valid
    size_t size;       // logical capacity in bytes (page-multiple)
    int fd;
};

// Round up to a page multiple and map the same memfd twice, adjacently.
fsdr_dbuf *fsdr_dbuf_create(size_t min_size) {
    long page = sysconf(_SC_PAGESIZE);
    if (page <= 0) page = 4096;
    size_t size = ((min_size + page - 1) / page) * page;
    if (size == 0) size = (size_t)page;

    int fd = memfd_create("fsdr_ringbuf", MFD_CLOEXEC);
    if (fd < 0) return nullptr;
    if (ftruncate(fd, (off_t)size) != 0) { close(fd); return nullptr; }

    // Reserve 2*size of address space, then overlay the two file mappings.
    void *reserve = mmap(nullptr, 2 * size, PROT_NONE,
                         MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (reserve == MAP_FAILED) { close(fd); return nullptr; }
    uint8_t *base = (uint8_t *)reserve;

    // MAP_POPULATE: fault every page of both mappings in now, once, rather
    // than page by page on the stream's first laps through the region
    // (measured by port_buffers.py "first"; PERF.md)
    void *a = mmap(base, size, PROT_READ | PROT_WRITE,
                   MAP_SHARED | MAP_FIXED | MAP_POPULATE, fd, 0);
    void *b = mmap(base + size, size, PROT_READ | PROT_WRITE,
                   MAP_SHARED | MAP_FIXED | MAP_POPULATE, fd, 0);
    if (a == MAP_FAILED || b == MAP_FAILED) {
        munmap(reserve, 2 * size);
        close(fd);
        return nullptr;
    }

    auto *h = (fsdr_dbuf *)std::malloc(sizeof(fsdr_dbuf));
    h->base = base;
    h->size = size;
    h->fd = fd;
    return h;
}

void fsdr_dbuf_destroy(fsdr_dbuf *h) {
    if (!h) return;
    munmap(h->base, 2 * h->size);
    close(h->fd);
    std::free(h);
}

uint8_t *fsdr_dbuf_ptr(fsdr_dbuf *h) { return h->base; }
size_t fsdr_dbuf_size(fsdr_dbuf *h) { return h->size; }

// ---------------------------------------------------------------------------
// Lock-free SPSC ring indices: one writer, up to FSDR_MAX_READERS readers.
// Positions are monotonically increasing byte/item counters (as in the Rust
// vmcircbuffer). The Python layer maps slices from these; produce/consume are
// single atomic read-modify-writes, safe between the writer's and the
// readers' threads.
// ---------------------------------------------------------------------------

#define FSDR_MAX_READERS 16

// Cache-line padding: the writer hammers wpos while each reader hammers its own rpos;
// sharing a line would false-share every produce/consume (the reference pads its SPSC
// indices the same way, perf/perf/src/spsc.rs).
struct alignas(128) fsdr_padded_u64 {
    std::atomic<uint64_t> v;
};

struct fsdr_ring {
    fsdr_padded_u64 wpos;
    fsdr_padded_u64 rpos[FSDR_MAX_READERS];
    std::atomic<uint32_t> reader_active;  // bitmask
    uint64_t capacity;                    // in items
};

fsdr_ring *fsdr_ring_create(uint64_t capacity_items) {
    auto *r = (fsdr_ring *)std::calloc(1, sizeof(fsdr_ring));
    r->capacity = capacity_items;
    return r;
}

void fsdr_ring_destroy(fsdr_ring *r) { std::free(r); }

int fsdr_ring_add_reader(fsdr_ring *r) {
    for (int i = 0; i < FSDR_MAX_READERS; i++) {
        uint32_t mask = r->reader_active.load(std::memory_order_acquire);
        if (!(mask & (1u << i))) {
            r->rpos[i].v.store(r->wpos.v.load(std::memory_order_acquire),
                             std::memory_order_release);
            if (r->reader_active.compare_exchange_strong(mask, mask | (1u << i)))
                return i;
            i--;  // raced; retry this slot scan
        }
    }
    return -1;
}

void fsdr_ring_remove_reader(fsdr_ring *r, int idx) {
    r->reader_active.fetch_and(~(1u << idx), std::memory_order_acq_rel);
}

uint64_t fsdr_ring_wpos(fsdr_ring *r) {
    return r->wpos.v.load(std::memory_order_acquire);
}

uint64_t fsdr_ring_rpos(fsdr_ring *r, int idx) {
    return r->rpos[idx].v.load(std::memory_order_acquire);
}

// Free space for the writer = capacity - max over active readers of (wpos - rpos).
uint64_t fsdr_ring_space(fsdr_ring *r) {
    uint64_t w = r->wpos.v.load(std::memory_order_acquire);
    uint32_t mask = r->reader_active.load(std::memory_order_acquire);
    uint64_t used = 0;
    for (int i = 0; i < FSDR_MAX_READERS; i++) {
        if (mask & (1u << i)) {
            uint64_t lag = w - r->rpos[i].v.load(std::memory_order_acquire);
            if (lag > used) used = lag;
        }
    }
    return r->capacity - used;
}

uint64_t fsdr_ring_available(fsdr_ring *r, int idx) {
    return r->wpos.v.load(std::memory_order_acquire) -
           r->rpos[idx].v.load(std::memory_order_acquire);
}

void fsdr_ring_produce(fsdr_ring *r, uint64_t n) {
    r->wpos.v.fetch_add(n, std::memory_order_acq_rel);
}

void fsdr_ring_consume(fsdr_ring *r, int idx, uint64_t n) {
    r->rpos[idx].v.fetch_add(n, std::memory_order_acq_rel);
}

}  // extern "C"
