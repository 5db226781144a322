// Native ingest/runtime support library.
//
// The reference's native surface is its device layer: int16 IQ streaming with
// elastic double-buffering and SIMD sample conversion (rx_sdrplay.cpp:199-291,
// libairspy iqconverter_*.c).  TPU hosts have no USB SDRs, but the framework
// keeps the native layer for the same jobs it does in the reference:
//   - bulk int16 -> float32 de-interleave + scale (AVX2 when available)
//   - a lock-free single-producer/single-consumer ring buffer for streaming
//     capture ingest at device rate without Python in the hot loop
//   - sustained-rate file readers and a UDP transport-stream sender
//     (1316-byte datagrams, the reference's VLC-compatible output,
//     bb_de_header.cpp:436-443)
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
//
// Build: see native/build.sh (g++ -O3 -march=native -shared -fPIC).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// int16 interleaved IQ -> float32 planar/interleaved conversion
// ---------------------------------------------------------------------------

// Convert n complex samples of interleaved int16 I/Q into interleaved
// float32 (re, im), scaled by `scale` (the device layer's int16->float job:
// dvbt2_demodulator.cpp:32-51 applies per-device scaling).
void iq_int16_to_float(const int16_t* in, float* out, int64_t n,
                       float scale) {
    int64_t i = 0;
#if defined(__AVX2__)
    const __m256 vscale = _mm256_set1_ps(scale);
    for (; i + 8 <= n; i += 8) {
        // 16 int16 values = 8 complex samples
        __m256i raw = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(in + 2 * i));
        __m128i lo = _mm256_castsi256_si128(raw);
        __m128i hi = _mm256_extracti128_si256(raw, 1);
        __m256 flo = _mm256_cvtepi32_ps(_mm256_cvtepi16_epi32(lo));
        __m256 fhi = _mm256_cvtepi32_ps(_mm256_cvtepi16_epi32(hi));
        _mm256_storeu_ps(out + 2 * i, _mm256_mul_ps(flo, vscale));
        _mm256_storeu_ps(out + 2 * i + 8, _mm256_mul_ps(fhi, vscale));
    }
#endif
    for (; i < n; ++i) {
        out[2 * i] = in[2 * i] * scale;
        out[2 * i + 1] = in[2 * i + 1] * scale;
    }
}

// ---------------------------------------------------------------------------
// SPSC ring buffer of float32 IQ pairs (elastic ingest buffering, the native
// equivalent of the reference's try_lock + grow-blocks scheme,
// rx_sdrplay.cpp:230-279)
// ---------------------------------------------------------------------------

struct Ring {
    float* data;           // 2*capacity floats
    int64_t capacity;      // complex samples
    std::atomic<int64_t> head;  // write index (samples)
    std::atomic<int64_t> tail;  // read index
    std::atomic<int64_t> overruns;
};

Ring* ring_create(int64_t capacity) {
    Ring* r = new Ring();
    r->data = static_cast<float*>(malloc(sizeof(float) * 2 * capacity));
    r->capacity = capacity;
    r->head.store(0);
    r->tail.store(0);
    r->overruns.store(0);
    return r;
}

void ring_destroy(Ring* r) {
    free(r->data);
    delete r;
}

int64_t ring_fill(const Ring* r) {
    return r->head.load(std::memory_order_acquire)
         - r->tail.load(std::memory_order_acquire);
}

int64_t ring_overruns(const Ring* r) { return r->overruns.load(); }

// Producer: push n float32-pair samples; drops (and counts) on overflow.
int64_t ring_push(Ring* r, const float* iq, int64_t n) {
    int64_t head = r->head.load(std::memory_order_relaxed);
    int64_t tail = r->tail.load(std::memory_order_acquire);
    int64_t space = r->capacity - (head - tail);
    int64_t take = n < space ? n : space;
    if (take < n) r->overruns.fetch_add(n - take);
    for (int64_t i = 0; i < take; ++i) {
        int64_t idx = (head + i) % r->capacity;
        r->data[2 * idx] = iq[2 * i];
        r->data[2 * idx + 1] = iq[2 * i + 1];
    }
    r->head.store(head + take, std::memory_order_release);
    return take;
}

// Producer variant: push int16 interleaved with conversion.
int64_t ring_push_int16(Ring* r, const int16_t* iq, int64_t n, float scale) {
    int64_t head = r->head.load(std::memory_order_relaxed);
    int64_t tail = r->tail.load(std::memory_order_acquire);
    int64_t space = r->capacity - (head - tail);
    int64_t take = n < space ? n : space;
    if (take < n) r->overruns.fetch_add(n - take);
    int64_t i = 0;
    while (i < take) {
        int64_t idx = (head + i) % r->capacity;
        int64_t run = r->capacity - idx;
        if (run > take - i) run = take - i;
        iq_int16_to_float(iq + 2 * i, r->data + 2 * idx, run, scale);
        i += run;
    }
    r->head.store(head + take, std::memory_order_release);
    return take;
}

// Consumer: pop up to n samples into out; returns count.
int64_t ring_pop(Ring* r, float* out, int64_t n) {
    int64_t tail = r->tail.load(std::memory_order_relaxed);
    int64_t head = r->head.load(std::memory_order_acquire);
    int64_t avail = head - tail;
    int64_t take = n < avail ? n : avail;
    for (int64_t i = 0; i < take; ++i) {
        int64_t idx = (tail + i) % r->capacity;
        out[2 * i] = r->data[2 * idx];
        out[2 * i + 1] = r->data[2 * idx + 1];
    }
    r->tail.store(tail + take, std::memory_order_release);
    return take;
}

// ---------------------------------------------------------------------------
// CRC-8 (poly 0xD5 MSB-first, init 0) over each row of an (n, m) byte
// matrix: the NM-mode per-packet CRC chain of the TS reassembler
// (bb_de_header.cpp:166-335).  One table walk per byte; at DVB-T2 rates
// this is the host tail's hot loop.
// ---------------------------------------------------------------------------

static const uint8_t* crc8_table() {
    static uint8_t tab[256];
    static bool init = false;
    if (!init) {
        for (int i = 0; i < 256; ++i) {
            uint8_t crc = 0;
            for (int j = 7; j >= 0; --j) {
                int bit = (i >> j) & 1;
                if (bit ^ (crc >> 7)) crc = static_cast<uint8_t>((crc << 1) ^ 0xD5);
                else crc = static_cast<uint8_t>(crc << 1);
            }
            tab[i] = crc;
        }
        init = true;
    }
    return tab;
}

void crc8_rows_strided(const uint8_t* rows, int64_t n, int64_t m,
                       int64_t stride, uint8_t* out) {
    const uint8_t* tab = crc8_table();
    int64_t i = 0;
    // 8 rows in flight: the table walk is a serial dependency chain per
    // row, so interleaving 8 independent chains keeps the load ports busy.
    // `stride` is the row pitch in bytes (>= m), so a column-sliced view
    // (e.g. the 187 payload bytes of 188-byte TS rows) needs no copy.
    for (; i + 8 <= n; i += 8) {
        const uint8_t* r[8];
        uint8_t c[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        for (int k = 0; k < 8; ++k) r[k] = rows + (i + k) * stride;
        for (int64_t j = 0; j < m; ++j) {
            for (int k = 0; k < 8; ++k) c[k] = tab[c[k] ^ r[k][j]];
        }
        for (int k = 0; k < 8; ++k) out[i + k] = c[k];
    }
    for (; i < n; ++i) {
        const uint8_t* r = rows + i * stride;
        uint8_t crc = 0;
        for (int64_t j = 0; j < m; ++j) crc = tab[crc ^ r[j]];
        out[i] = crc;
    }
}

void crc8_rows(const uint8_t* rows, int64_t n, int64_t m, uint8_t* out) {
    crc8_rows_strided(rows, n, m, m, out);
}

// ---------------------------------------------------------------------------
// File reader: bulk int16 capture -> float32 buffer (mmap-free, streamed)
// ---------------------------------------------------------------------------

int64_t read_ci16_file(const char* path, float* out, int64_t max_samples,
                       float scale) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    const int64_t chunk = 1 << 18;
    int16_t* buf = static_cast<int16_t*>(malloc(sizeof(int16_t) * 2 * chunk));
    int64_t total = 0;
    while (total < max_samples) {
        int64_t want = max_samples - total;
        if (want > chunk) want = chunk;
        size_t got = fread(buf, sizeof(int16_t) * 2, want, f);
        if (got == 0) break;
        iq_int16_to_float(buf, out + 2 * total,
                          static_cast<int64_t>(got), scale);
        total += static_cast<int64_t>(got);
    }
    free(buf);
    fclose(f);
    return total;
}

// ---------------------------------------------------------------------------
// UDP TS sender (1316-byte datagrams to a VLC-style receiver)
// ---------------------------------------------------------------------------

struct UdpTs {
    int fd;
    sockaddr_in addr;
};

UdpTs* udp_ts_open(const char* host, int port) {
    UdpTs* u = new UdpTs();
    u->fd = socket(AF_INET, SOCK_DGRAM, 0);
    if (u->fd < 0) { delete u; return nullptr; }
    memset(&u->addr, 0, sizeof(u->addr));
    u->addr.sin_family = AF_INET;
    u->addr.sin_port = htons(static_cast<uint16_t>(port));
    inet_pton(AF_INET, host, &u->addr.sin_addr);
    return u;
}

int64_t udp_ts_send(UdpTs* u, const uint8_t* ts, int64_t n_bytes) {
    const int64_t chunk = 188 * 7;
    int64_t sent = 0;
    while (sent < n_bytes) {
        int64_t take = n_bytes - sent;
        if (take > chunk) take = chunk;
        ssize_t rc = sendto(u->fd, ts + sent, static_cast<size_t>(take), 0,
                            reinterpret_cast<sockaddr*>(&u->addr),
                            sizeof(u->addr));
        if (rc < 0) return sent;
        sent += take;
    }
    return sent;
}

void udp_ts_close(UdpTs* u) {
    close(u->fd);
    delete u;
}

}  // extern "C"
