// Native host-side DBDE record IO for the reader: scanning and batched
// field gather at memcpy speed.
//
// The port's own copy of dbde_tpu/native/dbde_io.cpp: the equivalent of the
// reference's C++ file layer (dbde_file_walker, dbde_util.cpp:362-426)
// redesigned for a batched device codec: instead of decoding one frame per call, the host scans and splits
// many self-delimiting records at once, moving bytes from the on-disk
// ragged layout into the device's fixed-stride arrays.  The writer lays
// out records in Python (codec.record_iovecs) and hands them to writev.  Compiled with
// -O3 -march=native; exposed through a plain C ABI for ctypes.
//
// Record layout parity (dbde_util.cpp:137-196): 20-byte frame header
// (i32 u64s=2, u64 index, f64 elapsed), then i32 T, u8 depths[T], i32 T,
// u8 mins[T], i32 n64, u64 payload[n64]; all little-endian.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline int32_t rd_i32(const uint8_t* p) {
    int32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

inline uint32_t rd_u32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

constexpr long FRAME_HEADER = 20;

inline long sum_depths(const uint8_t* d, long t) {
    long s = 0;
    for (long i = 0; i < t; i++) s += d[i];
    return s;
}

template <class F>
void parallel_over(long n, int threads, F&& f) {
    if (threads <= 1 || n < 2) {
        for (long i = 0; i < n; i++) f(i);
        return;
    }
    std::vector<std::thread> pool;
    long per = (n + threads - 1) / threads;
    for (int t = 0; t < threads; t++) {
        long lo = t * per, hi = std::min(n, lo + per);
        if (lo >= hi) break;
        pool.emplace_back([&, lo, hi] {
            for (long i = lo; i < hi; i++) f(i);
        });
    }
    for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Validate + measure one record at `off` (pointing at the frame header).
// Returns the full record size, or 0 if truncated/corrupt (the reference's
// hard-error parity: any count mismatch kills the walk, dbde_util.cpp:295-303).
long dbde_record_size(const uint8_t* buf, long len, long off, long tiles) {
    if (len - off < FRAME_HEADER + 12 + 2 * tiles) return 0;
    if (rd_u32(buf + off) != 2u) return 0;
    const uint8_t* p = buf + off + FRAME_HEADER;
    if (rd_i32(p) != tiles) return 0;
    if (rd_i32(p + 4 + tiles) != tiles) return 0;
    long n64 = rd_i32(p + 8 + 2 * tiles);
    if (n64 < 0 || n64 != sum_depths(p + 4, tiles)) return 0;
    long size = FRAME_HEADER + 12 + 2 * tiles + 8 * n64;
    return (len - off >= size) ? size : 0;
}

// Scan up to max_records sequential records starting at `start`.
// Fills offsets[] (record starts) and sizes[]; returns the count.
long dbde_scan_records(const uint8_t* buf, long len, long start, long tiles,
                       long max_records, long* offsets, long* sizes) {
    long n = 0, off = start;
    while (n < max_records) {
        long sz = dbde_record_size(buf, len, off, tiles);
        if (sz == 0) break;
        offsets[n] = off;
        sizes[n] = sz;
        off += sz;
        n++;
    }
    return n;
}

// Batched ragged->fixed-stride parse.  data_offsets[b] points at each
// record's frame DATA (after the 20-byte header).  payload rows are
// zero-padded to payload_stride_words.  Returns 0 on success, b+1 on the
// first bad record.
long dbde_gather_fields(const uint8_t* buf, long len, const long* data_offsets,
                        long batch, long tiles, uint8_t* depths, uint8_t* mins,
                        uint32_t* payload, long payload_stride_words,
                        int32_t* n64s, int threads) {
    std::atomic<long> bad{0};
    parallel_over(batch, threads, [&](long b) {
        long off = data_offsets[b];
        const uint8_t* p = buf + off;
        if (len - off < 12 + 2 * tiles || rd_i32(p) != tiles ||
            rd_i32(p + 4 + tiles) != tiles) {
            bad.store(b + 1, std::memory_order_relaxed);
            return;
        }
        long n64 = rd_i32(p + 8 + 2 * tiles);
        if (n64 < 0 || n64 != sum_depths(p + 4, tiles) ||
            len - off < 12 + 2 * tiles + 8 * n64 ||
            2 * n64 > payload_stride_words) {
            bad.store(b + 1, std::memory_order_relaxed);
            return;
        }
        std::memcpy(depths + b * tiles, p + 4, tiles);
        std::memcpy(mins + b * tiles, p + 8 + tiles, tiles);
        uint32_t* dst = payload + b * payload_stride_words;
        std::memcpy(dst, p + 12 + 2 * tiles, 8 * n64);
        std::memset(dst + 2 * n64, 0, 4 * (payload_stride_words - 2 * n64));
        n64s[b] = (int32_t)n64;
    });
    return bad.load(std::memory_order_relaxed);
}

}  // extern "C"
