// Byte-span copy and fill by a whole block, in 16-byte words (K4, K16).
//
// A span is written as whole 16-byte words between a head and a tail of
// fewer than 16 bytes.  Each word is loaded as 16 bytes where the source
// offset is 16-byte aligned too, or else as the two aligned source words
// that cover it, shifted into place by funnel shifts (a span that starts
// at an odd row of 8 B, rows of 6 B).  The fill stores 16-byte words of
// a pattern whose byte i belongs at leaf offset i mod 16.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// bytes [off, off + 16) of the 32 bytes a:b, off = 4 * Q + sh / 8
template <int Q>
__device__ __forceinline__ uint4 span_shift(uint4 a, uint4 b, unsigned sh) {
  const unsigned u[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  return make_uint4(__funnelshift_r(u[Q], u[Q + 1], sh),
                    __funnelshift_r(u[Q + 1], u[Q + 2], sh),
                    __funnelshift_r(u[Q + 2], u[Q + 3], sh),
                    __funnelshift_r(u[Q + 3], u[Q + 4], sh));
}

// nw 16-byte words to q from src (src - off 16-byte aligned, 0 < off <
// 16 when Q >= 0: each word from the two aligned words that cover it;
// Q < 0: src aligned); UNROLL words a thread in flight
template <int THREADS, int UNROLL, int Q>
__device__ __forceinline__ void span_words(const char* src, uint4* q,
                                           int64_t nw, unsigned sh) {
  const uint4* s = (const uint4*)(src - (Q < 0 ? 0 : 4 * Q + sh / 8));
  for (int64_t w0 = threadIdx.x; w0 < nw;
       w0 += (int64_t)THREADS * UNROLL) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t w = w0 + (int64_t)u * THREADS;
      if (w < nw) {
        if constexpr (Q < 0)
          v[u] = __ldg(s + w);
        else
          v[u] = span_shift<Q>(__ldg(s + w), __ldg(s + w + 1), sh);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t w = w0 + (int64_t)u * THREADS;
      if (w < nw) q[w] = v[u];
    }
  }
}

// len bytes from src to out by the block (THREADS >= 48): a head and a
// tail of fewer than 16 bytes, 16-byte words between them
template <int THREADS, int UNROLL>
__device__ __forceinline__ void span_copy(const char* src, char* out,
                                          int64_t len) {
  int64_t head = (int64_t)((16 - ((uintptr_t)out & 15)) & 15);
  if (head > len) head = len;
  const int64_t nw = (len - head) >> 4, tail0 = head + (nw << 4);
  if (threadIdx.x < head)
    out[threadIdx.x] = src[threadIdx.x];
  else if (threadIdx.x >= 32 && threadIdx.x - 32 < len - tail0)
    out[tail0 + threadIdx.x - 32] = src[tail0 + threadIdx.x - 32];
  const char* s = src + head;
  uint4* q = (uint4*)(out + head);
  const unsigned off = (unsigned)((uintptr_t)s & 15), sh = (off & 3) * 8;
  switch (off == 0 ? -1 : (int)(off >> 2)) {
    case -1: span_words<THREADS, UNROLL, -1>(s, q, nw, 0); break;
    case 0: span_words<THREADS, UNROLL, 0>(s, q, nw, sh); break;
    case 1: span_words<THREADS, UNROLL, 1>(s, q, nw, sh); break;
    case 2: span_words<THREADS, UNROLL, 2>(s, q, nw, sh); break;
    default: span_words<THREADS, UNROLL, 3>(s, q, nw, sh); break;
  }
}

// len bytes of the pattern p at out by the block (THREADS >= 48); a
// byte's place in the pattern is its offset from the 16-byte aligned
// leaf base
template <int THREADS>
__device__ __forceinline__ void span_fill(const char* base, char* out,
                                          int64_t len, uint4 p) {
  int64_t head = (int64_t)((16 - ((uintptr_t)out & 15)) & 15);
  if (head > len) head = len;
  const int64_t nw = (len - head) >> 4, tail0 = head + (nw << 4);
  const unsigned char* pb = (const unsigned char*)&p;
  if (threadIdx.x < head)
    out[threadIdx.x] = pb[(out + threadIdx.x - base) & 15];
  else if (threadIdx.x >= 32 && threadIdx.x - 32 < len - tail0)
    out[tail0 + threadIdx.x - 32] =
        pb[(out + tail0 + threadIdx.x - 32 - base) & 15];
  uint4* q = (uint4*)(out + head);
  for (int64_t w = threadIdx.x; w < nw; w += THREADS) q[w] = p;
}

// a fill value of `width` bytes (1, 2, 4 or 8; its bits in the low
// bytes of v) repeated over 16 bytes
static inline uint4 span_pattern(uint64_t v, int width) {
  uint64_t f = v;
  if (width == 1) f = (v & 0xffull) * 0x0101010101010101ull;
  if (width == 2) f = (v & 0xffffull) * 0x0001000100010001ull;
  if (width == 4) f = (v & 0xffffffffull) * 0x0000000100000001ull;
  return make_uint4((unsigned)f, (unsigned)(f >> 32), (unsigned)f,
                    (unsigned)(f >> 32));
}
