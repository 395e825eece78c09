// K14 segmented_merge: each run's merge of a traced user merge over the
// key-sorted rows of every shard.  Rows >= n[s] are ignored; each run's
// last valid row receives the run's values merged left to right in row
// order (a fixed association, so the result is deterministic), in each
// leaf's dtype.  Other rows are left as they are.
//
// Replaces dpark_tpu/backend/tpu/collectives.py:303 (segmented_combine: a
// lax.associative_scan of the traced merge, log2(cap) merge steps over
// every row).  The merge arrives as a register program
// (backend/cuda/merge_program.py): straight-line code over 64-bit
// registers, a's slots in [0, S), b's in [S, 2S), then constants and
// temporaries; one slot per lane of each value leaf.
//
// Bound: bytes.  Each row's flag (1 B) and its S slots are read once, and
// each run's S slots written once: (1 + slot bytes) x rows + slot bytes x
// runs.  Design: one pass a level.  A block of K14_THREADS threads loads a
// tile of K14_ROWS rows of every slot into shared memory (coalesced,
// padded against bank conflicts), then each thread folds K14_C consecutive
// rows through the program, writing each run that ends in its chunk at
// its last row, and the fold of its chunk's last run (with a flag: did the
// run start inside the chunk) into the (N, ceil(cap / K14_C), S) array of
// the next level.  The same kernel runs on that array, recursively, until
// a level fits one chunk; then a fix-up pass a level, top down, merges
// the carry of the runs that crossed chunks into the head run of each
// chunk (the runs that end there).  One run may span a whole shard.  The
// program, its constants and the slot table sit in shared memory, loaded
// once a block (a loop-indexed parameter struct would go to local memory).
#include "common.cuh"

#define K14_MAX_SLOTS 16
#define K14_MAX_REGS 96
#define K14_MAX_INSTRS 256
#define K14_WORDS 6
#define K14_C 8
#define K14_THREADS 128
#define K14_ROWS (K14_THREADS * K14_C)
#define K14_TILE (K14_ROWS + K14_ROWS / K14_C)
#define K14_PAD(e) ((e) + (e) / K14_C)

// dtype codes and opcodes: merge_program.py
enum { T_I64 = 0, T_I32 = 1, T_F64 = 2, T_F32 = 3, T_BOOL = 4, T_RAW = 5 };
enum {
  OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_FLOORDIV, OP_REM, OP_NEG, OP_ABS,
  OP_MIN, OP_MAX, OP_WHERE, OP_EQ, OP_NE, OP_LT, OP_LE, OP_GT, OP_GE,
  OP_LAND, OP_LOR, OP_LXOR, OP_LNOT, OP_BAND, OP_BOR, OP_BXOR, OP_BNOT,
  OP_CAST
};

// one level's slots: row g of slot j is element g * stride[j] of in[j]
// (read) and out[j] (written), of dtype type[j]
struct K14Slots {
  const char* in[K14_MAX_SLOTS];
  char* out[K14_MAX_SLOTS];
  long long stride[K14_MAX_SLOTS];
  int type[K14_MAX_SLOTS];
};

struct K14Shared {
  int code[K14_MAX_INSTRS * K14_WORDS];
  int creg[K14_MAX_REGS];
  long long cval[K14_MAX_REGS];
  int out[K14_MAX_SLOTS];
  K14Slots sl;
  int nins, ncon, S;
};

__device__ __forceinline__ double as_d(long long x) {
  return __longlong_as_double(x);
}
__device__ __forceinline__ long long d_bits(double x) {
  return __double_as_longlong(x);
}
__device__ __forceinline__ float as_f(long long x) {
  return __int_as_float((int)x);
}
__device__ __forceinline__ long long f_bits(float x) {
  return (long long)(unsigned)__float_as_int(x);
}

__device__ __forceinline__ long long ld_slot(const char* p, int t,
                                             long long i) {
  switch (t) {
    case T_I32: return (long long)((const int*)p)[i];
    case T_F32: return (long long)((const unsigned*)p)[i];
    case T_BOOL: return (long long)(((const unsigned char*)p)[i] != 0);
    default: return ((const long long*)p)[i];
  }
}

__device__ __forceinline__ void st_slot(char* p, int t, long long i,
                                        long long v) {
  switch (t) {
    case T_I32: ((int*)p)[i] = (int)v; break;
    case T_F32: ((unsigned*)p)[i] = (unsigned)v; break;
    case T_BOOL: ((unsigned char*)p)[i] = (unsigned char)(v != 0); break;
    default: ((long long*)p)[i] = v;
  }
}

// torch's c10::div_floor_floating (Python's float //), without FMA
__device__ __forceinline__ double floordiv_d(double a, double b) {
  if (b == 0.0) return __ddiv_rn(a, b);
  const double mod = fmod(a, b);
  double div = __ddiv_rn(__dsub_rn(a, mod), b);
  if (mod != 0.0 && ((b < 0.0) != (mod < 0.0))) div = __dsub_rn(div, 1.0);
  if (div == 0.0) return copysign(0.0, __ddiv_rn(a, b));
  double fl = floor(div);
  if (__dsub_rn(div, fl) > 0.5) fl = __dadd_rn(fl, 1.0);
  return fl;
}
__device__ __forceinline__ float floordiv_f(float a, float b) {
  if (b == 0.0f) return __fdiv_rn(a, b);
  const float mod = fmodf(a, b);
  float div = __fdiv_rn(__fsub_rn(a, mod), b);
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f)))
    div = __fsub_rn(div, 1.0f);
  if (div == 0.0f) return copysignf(0.0f, __fdiv_rn(a, b));
  float fl = floorf(div);
  if (__fsub_rn(div, fl) > 0.5f) fl = __fadd_rn(fl, 1.0f);
  return fl;
}

__device__ long long k14_float(int op, bool f32, long long xa,
                               long long xb) {
  if (f32) {
    const float a = as_f(xa), b = as_f(xb);
    switch (op) {
      case OP_ADD: return f_bits(__fadd_rn(a, b));
      case OP_SUB: return f_bits(__fsub_rn(a, b));
      case OP_MUL: return f_bits(__fmul_rn(a, b));
      case OP_DIV: return f_bits(__fdiv_rn(a, b));
      case OP_FLOORDIV: return f_bits(floordiv_f(a, b));
      case OP_REM: {
        float m = fmodf(a, b);
        if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m = __fadd_rn(m, b);
        return f_bits(m);
      }
      case OP_NEG: return f_bits(-a);
      case OP_ABS: return f_bits(fabsf(a));
      case OP_MIN: return f_bits(a != a || b != b ? __fadd_rn(a, b)
                                                  : (b < a ? b : a));
      case OP_MAX: return f_bits(a != a || b != b ? __fadd_rn(a, b)
                                                  : (b > a ? b : a));
      case OP_EQ: return a == b;
      case OP_NE: return a != b;
      case OP_LT: return a < b;
      case OP_LE: return a <= b;
      case OP_GT: return a > b;
      default: return a >= b;
    }
  }
  const double a = as_d(xa), b = as_d(xb);
  switch (op) {
    case OP_ADD: return d_bits(__dadd_rn(a, b));
    case OP_SUB: return d_bits(__dsub_rn(a, b));
    case OP_MUL: return d_bits(__dmul_rn(a, b));
    case OP_DIV: return d_bits(__ddiv_rn(a, b));
    case OP_FLOORDIV: return d_bits(floordiv_d(a, b));
    case OP_REM: {
      double m = fmod(a, b);
      if (m != 0.0 && ((b < 0.0) != (m < 0.0))) m = __dadd_rn(m, b);
      return d_bits(m);
    }
    case OP_NEG: return d_bits(-a);
    case OP_ABS: return d_bits(fabs(a));
    case OP_MIN: return d_bits(a != a || b != b ? __dadd_rn(a, b)
                                                : (b < a ? b : a));
    case OP_MAX: return d_bits(a != a || b != b ? __dadd_rn(a, b)
                                                : (b > a ? b : a));
    case OP_EQ: return a == b;
    case OP_NE: return a != b;
    case OP_LT: return a < b;
    case OP_LE: return a <= b;
    case OP_GT: return a > b;
    default: return a >= b;
  }
}

// integers (int64, int32 sign-extended) and bools (0/1); wraps like torch
__device__ long long k14_int(int op, int t, long long a, long long b) {
  typedef unsigned long long u64;
  long long v;
  switch (op) {
    case OP_ADD:
      v = t == T_BOOL ? ((a | b) != 0) : (long long)((u64)a + (u64)b);
      break;
    case OP_SUB: v = (long long)((u64)a - (u64)b); break;
    case OP_MUL:
      v = t == T_BOOL ? (a & b) : (long long)((u64)a * (u64)b);
      break;
    case OP_FLOORDIV:
      // torch's c10::div_floor_integer; x // 0 gives 0
      if (b == 0) v = 0;
      else if (b == -1) v = (long long)(0ULL - (u64)a);
      else {
        const long long q = a / b, r = a % b;
        v = (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
      }
      break;
    case OP_REM:
      if (b == 0 || b == -1) v = 0;
      else {
        const long long r = a % b;
        v = (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
      }
      break;
    case OP_NEG: v = (long long)(0ULL - (u64)a); break;
    case OP_ABS: v = a < 0 ? (long long)(0ULL - (u64)a) : a; break;
    case OP_MIN: v = b < a ? b : a; break;
    case OP_MAX: v = b > a ? b : a; break;
    case OP_EQ: return a == b;
    case OP_NE: return a != b;
    case OP_LT: return a < b;
    case OP_LE: return a <= b;
    case OP_GT: return a > b;
    case OP_GE: return a >= b;
    case OP_LAND: return (a != 0) && (b != 0);
    case OP_LOR: return (a != 0) || (b != 0);
    case OP_LXOR: return (a != 0) != (b != 0);
    case OP_LNOT: return a == 0;
    case OP_BAND: v = a & b; break;
    case OP_BOR: v = a | b; break;
    case OP_BXOR: v = a ^ b; break;
    default: v = t == T_BOOL ? (a == 0) : ~a; break;  // OP_BNOT
  }
  return t == T_I32 ? (long long)(int)v : v;
}

__device__ long long k14_cast(long long x, int from, int to) {
  if (from == to) return x;
  if (from == T_F64 || from == T_F32) {
    const double d = from == T_F64 ? as_d(x) : (double)as_f(x);
    switch (to) {
      case T_F64: return d_bits(d);
      case T_F32: return f_bits(__double2float_rn(d));
      case T_BOOL: return d != 0.0;
      case T_I32: return (long long)(from == T_F64 ? __double2int_rz(d)
                                                   : __float2int_rz(as_f(x)));
      default: return from == T_F64 ? __double2ll_rz(d)
                                    : __float2ll_rz(as_f(x));
    }
  }
  switch (to) {  // from an integer or a bool
    case T_F64: return d_bits(__ll2double_rn(x));
    case T_F32: return f_bits(__ll2float_rn(x));
    case T_BOOL: return x != 0;
    case T_I32: return (long long)(int)x;
    default: return x;
  }
}

__device__ __forceinline__ void k14_run(long long* r, const K14Shared& p) {
  for (int k = 0; k < p.nins; ++k) {
    const int* w = p.code + K14_WORDS * k;
    const int op = w[0], t = w[1];
    const long long a = r[w[3]], b = r[w[4]];
    long long v;
    if (op == OP_CAST)
      v = k14_cast(a, w[5], t);
    else if (op == OP_WHERE)
      v = a ? b : r[w[5]];
    else if (t == T_F64 || t == T_F32)
      v = k14_float(op, t == T_F32, a, b);
    else
      v = k14_int(op, t, a, b);
    r[w[2]] = v;
  }
}

// acc (registers [0, S)) = merge(acc, b (registers [S, 2S)))
__device__ __forceinline__ void k14_merge(long long* r, const K14Shared& p) {
  long long tmp[K14_MAX_SLOTS];
  k14_run(r, p);
  for (int j = 0; j < p.S; ++j) tmp[j] = r[p.out[j]];
  for (int j = 0; j < p.S; ++j) r[j] = tmp[j];
}

__device__ void k14_load_program(K14Shared& p, const long long* pbuf,
                                 const K14Slots& sl) {
  const int nins = (int)pbuf[0], ncon = (int)pbuf[1], S = (int)pbuf[2];
  const long long* code = pbuf + 3;
  const long long* con = code + (long long)K14_WORDS * nins;
  const long long* out = con + 2 * ncon;
  for (int i = threadIdx.x; i < K14_WORDS * nins; i += blockDim.x)
    p.code[i] = (int)code[i];
  for (int i = threadIdx.x; i < ncon; i += blockDim.x) {
    p.creg[i] = (int)con[2 * i];
    p.cval[i] = con[2 * i + 1];
  }
  for (int i = threadIdx.x; i < S; i += blockDim.x) p.out[i] = (int)out[i];
  if (threadIdx.x == 0) {
    p.nins = nins;
    p.ncon = ncon;
    p.S = S;
    p.sl = sl;
  }
}

__device__ __forceinline__ long long level_rows(const int* n0, int s,
                                                int level) {
  long long nv = n0[s];
  for (int l = 0; l < level; ++l) nv = (nv + K14_C - 1) / K14_C;
  return nv;
}

// One level's fold.  flags: (N, cap) run starts of this level; part /
// pflag: the next level's (N, cap1, S) raw slots and (N, cap1) flags
// (null at the top level).
static __global__ void __launch_bounds__(K14_THREADS)
k14_fold(K14Slots sl, const long long* __restrict__ pbuf,
         const unsigned char* __restrict__ flags, const int* __restrict__ n0,
         int level, long long cap, long long* part, unsigned char* pflag,
         long long cap1) {
  extern __shared__ long long tile[];
  __shared__ K14Shared p;
  k14_load_program(p, pbuf, sl);
  const int s = blockIdx.y;
  const long long nv = level_rows(n0, s, level);
  const long long row0 = (long long)blockIdx.x * K14_ROWS;
  __syncthreads();
  if (row0 >= nv) return;
  const int S = p.S;
  const long long base = (long long)s * cap;
  unsigned char* fl = (unsigned char*)(tile + (long long)S * K14_TILE);
  for (int j = 0; j < S; ++j) {
    const char* src = p.sl.in[j];
    const int t = p.sl.type[j];
    const long long st = p.sl.stride[j];
    for (int e = threadIdx.x; e < K14_ROWS; e += K14_THREADS) {
      const long long g = row0 + e;
      tile[j * K14_TILE + K14_PAD(e)] =
          g < nv ? ld_slot(src, t, (base + g) * st) : 0;
    }
  }
  // one flag past the tile: does the next row start a run (or is past n)
  for (int e = threadIdx.x; e <= K14_ROWS; e += K14_THREADS) {
    const long long g = row0 + e;
    fl[e] = g < nv ? (flags[base + g] != 0 || g == 0) : 1;
  }
  __syncthreads();
  const int tid = threadIdx.x;
  const long long g0 = row0 + (long long)tid * K14_C;
  if (g0 >= nv) return;
  long long r[K14_MAX_REGS];
  for (int c = 0; c < p.ncon; ++c) r[p.creg[c]] = p.cval[c];
  bool has_start = false;
  for (int k = 0; k < K14_C; ++k) {
    const long long g = g0 + k;
    if (g >= nv) break;
    const int e = tid * K14_C + k;
    const bool st = fl[e] != 0;
    const long long* row = tile + K14_PAD(e);
    if (st || k == 0) {
      for (int j = 0; j < S; ++j) r[j] = row[j * K14_TILE];
    } else {
      for (int j = 0; j < S; ++j) r[S + j] = row[j * K14_TILE];
      k14_merge(r, p);
    }
    has_start |= st;
    if (fl[e + 1]) {
      for (int j = 0; j < S; ++j)
        st_slot(p.sl.out[j], p.sl.type[j], (base + g) * p.sl.stride[j],
                r[j]);
    }
  }
  if (part != nullptr) {
    const long long ci = g0 / K14_C;
    for (int j = 0; j < S; ++j)
      part[((long long)s * cap1 + ci) * S + j] = r[j];
    pflag[(long long)s * cap1 + ci] = has_start;
  }
}

// One level's fix-up, after the next level (res: its (N, cap1, S) raw
// slots, final at its run ends) is done: the head run of each chunk that
// does not start a run is the tail of a run from earlier chunks.
static __global__ void k14_fixup(K14Slots sl,
                                 const long long* __restrict__ pbuf,
                                 const unsigned char* __restrict__ flags,
                                 const int* __restrict__ n0, int level,
                                 long long cap, const long long* res,
                                 long long cap1) {
  __shared__ K14Shared p;
  k14_load_program(p, pbuf, sl);
  __syncthreads();
  const int s = blockIdx.y;
  const long long nv = level_rows(n0, s, level);
  const long long ci = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long g0 = ci * K14_C;
  const long long base = (long long)s * cap;
  if (g0 >= nv || g0 == 0 || flags[base + g0]) return;
  const int S = p.S;
  const long long last = (g0 + K14_C < nv ? g0 + K14_C : nv) - 1;
  long long end = -1;
  for (long long g = g0 + 1; g <= last; ++g)
    if (flags[base + g]) {
      end = g - 1;
      break;
    }
  long long r[K14_MAX_REGS];
  if (end >= 0) {
    // the head run ends inside the chunk, before a start: carry (the
    // next level's row ci - 1, the end of its run there) merged with
    // the head's fold
    for (int c = 0; c < p.ncon; ++c) r[p.creg[c]] = p.cval[c];
    const long long* carry = res + ((long long)s * cap1 + ci - 1) * S;
    for (int j = 0; j < S; ++j) {
      r[j] = carry[j];
      r[S + j] = ld_slot(p.sl.out[j], p.sl.type[j],
                         (base + end) * p.sl.stride[j]);
    }
    k14_merge(r, p);
  } else if (last + 1 >= nv || flags[base + last + 1]) {
    // no run starts in the chunk and one ends at its last row: the next
    // level's row ci is the whole run
    end = last;
    const long long* whole = res + ((long long)s * cap1 + ci) * S;
    for (int j = 0; j < S; ++j) r[j] = whole[j];
  } else {
    return;
  }
  for (int j = 0; j < S; ++j)
    st_slot(p.sl.out[j], p.sl.type[j], (base + end) * p.sl.stride[j], r[j]);
}

static K14Slots raw_slots(long long* part, int S) {
  K14Slots sl;
  for (int j = 0; j < K14_MAX_SLOTS; ++j) {
    sl.in[j] = j < S ? (const char*)(part + j) : nullptr;
    sl.out[j] = j < S ? (char*)(part + j) : nullptr;
    sl.stride[j] = S;
    sl.type[j] = T_RAW;
  }
  return sl;
}

// in / out: S slot pointers (a leaf's data pointer plus its lane offset);
// types: the slots' dtype codes; strides: each slot's lanes per row.
// pbuf: the device program (merge_program.Program.words); flags: (N, cap)
// bool run starts; n: (N,) valid rows.  scratch: at least
// dpk_segmented_merge_scratch(N, cap, S) bytes.
extern "C" long long dpk_segmented_merge_scratch(int N, long long cap,
                                                 int S) {
  long long total = 0;
  for (long long c = cap; c > K14_C;) {
    c = (c + K14_C - 1) / K14_C;
    total += (long long)N * c * S * 8 + (((long long)N * c + 7) / 8) * 8;
  }
  return total;
}

extern "C" int dpk_segmented_merge(const void* const* in, void* const* out,
                                   const int* types,
                                   const long long* strides, int S,
                                   const long long* pbuf,
                                   const unsigned char* flags, const int* n,
                                   int N, long long cap, void* scratch,
                                   long long scratch_bytes, void* stream) {
  if (S < 1 || S > K14_MAX_SLOTS || N < 1 || N > 65535)
    return (int)cudaErrorInvalidValue;
  if (cap == 0) return (int)cudaGetLastError();
  if (scratch_bytes < dpk_segmented_merge_scratch(N, cap, S))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  long long caps[64];
  long long* part[64];
  unsigned char* pfl[64];
  int top = 0;
  caps[0] = cap;
  char* sp = (char*)scratch;
  while (caps[top] > K14_C) {
    const long long c = (caps[top] + K14_C - 1) / K14_C;
    ++top;
    caps[top] = c;
    part[top] = (long long*)sp;
    sp += (long long)N * c * S * 8;
    pfl[top] = (unsigned char*)sp;
    sp += (((long long)N * c + 7) / 8) * 8;
  }
  K14Slots sl0;
  for (int j = 0; j < K14_MAX_SLOTS; ++j) {
    sl0.in[j] = j < S ? (const char*)in[j] : nullptr;
    sl0.out[j] = j < S ? (char*)out[j] : nullptr;
    sl0.stride[j] = j < S ? strides[j] : 0;
    sl0.type[j] = j < S ? types[j] : T_RAW;
  }
  const size_t smem = (size_t)S * K14_TILE * 8 + K14_ROWS + 8;
  cudaError_t err = cudaFuncSetAttribute(
      k14_fold, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int l = 0; l <= top; ++l) {
    const K14Slots sl = l == 0 ? sl0 : raw_slots(part[l], S);
    dim3 grid((unsigned)((caps[l] + K14_ROWS - 1) / K14_ROWS), (unsigned)N);
    k14_fold<<<grid, K14_THREADS, smem, st>>>(
        sl, pbuf, l == 0 ? flags : pfl[l], n, l, caps[l],
        l < top ? part[l + 1] : nullptr, l < top ? pfl[l + 1] : nullptr,
        l < top ? caps[l + 1] : 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  for (int l = top - 1; l >= 0; --l) {
    const K14Slots sl = l == 0 ? sl0 : raw_slots(part[l], S);
    const long long chunks = (caps[l] + K14_C - 1) / K14_C;
    dim3 grid((unsigned)((chunks + 255) / 256), (unsigned)N);
    k14_fixup<<<grid, 256, 0, st>>>(sl, pbuf, l == 0 ? flags : pfl[l], n,
                                    l, caps[l], part[l + 1], caps[l + 1]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
