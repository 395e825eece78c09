// K14 segmented_merge (the device code; segmented_merge.cu holds the
// instances for up to 6 slots, segmented_merge_wide.cu those for up to
// 16, so that the two halves build in parallel): each run's merge of a
// traced user merge over the key-sorted rows of every shard.  Rows >=
// n[s] are ignored; each run's
// last valid row receives the run's values merged left to right in row
// order, in each leaf's dtype.  Other rows are left as they are.  The
// association is fixed by the tiling (no atomics, no order that depends
// on timing), so a run gives the same bits every time.
//
// Replaces dpark_tpu/backend/tpu/collectives.py:303 (segmented_combine: a
// lax.associative_scan of the traced merge, log2(cap) merge steps over
// every row).  The merge arrives as a register program
// (backend/cuda/merge_program.py): straight-line code over 64-bit
// registers, a's slots in [0, S), b's in [S, 2S), then constants and
// temporaries; one slot per lane of each value leaf.  A lane-separable
// program (every merged slot j is op(a_j, b_j), op one of add, min, max,
// mul in the slot's dtype; the host passes the ops) is folded with its op
// per slot in registers, without the interpreter: "K14 separable".
//
// Bound: bytes.  Each row's flag (1 B) and its S slots are read once, and
// each run's S slots written once: (1 + slot bytes) x rows + slot bytes x
// runs.  Design: a per-shard reduce-then-scan in two launches.
// 1. k14_tiles: a warp is a tile of K14_TILE rows, taken a group of 32 x
//    C rows at a time.  The warp reads the group's flags and slots
//    coalesced (row k * 32 + lane; the flags as one ballot a row set) and
//    turns the slots around through its own shared memory (padded, no
//    bank conflicts), so that each lane folds C consecutive rows, writing
//    every run that starts and ends in its chunk.  A segmented warp scan
//    of the lanes' (has a start, fold of the last run) pairs by shuffles
//    (five merges a group), with the carry of the tile's earlier groups
//    from lane 31, finishes every run that starts in the tile.  The tile
//    leaves its head run's fold and end row (a run that began in an
//    earlier tile) and its own pair.
// 2. k14_carry: a warp a shard scans its tiles' pairs 32 at a time and
//    writes each tile's head run.
// The values being merged stay in registers; the slot count is a template
// bound (2, 6 or 16: three instances a route keep the build short), and
// C is 8 (4 past 8 slots).  The
// interpreter's register file is each warp's own block of dynamic shared
// memory, laid out register-major ([reg][lane], no bank conflicts) and
// sized by the program's register count, not a local array indexed at
// run time; a merge copies a's and b's slots in, runs the program and
// reads the merged slots out.  The program and its constants sit in
// shared memory, loaded once a block.
#pragma once
#include "common.cuh"

#define K14_MAX_SLOTS 16
#define K14_MAX_REGS 96
#define K14_MAX_INSTRS 256
#define K14_WORDS 6
#define K14_TILE 8192              // rows a warp's tile
#define K14_WARPS 4                // tiles (warps) a block

// dtype codes and opcodes: merge_program.py
enum { T_I64 = 0, T_I32 = 1, T_F64 = 2, T_F32 = 3, T_BOOL = 4 };
enum {
  OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_FLOORDIV, OP_REM, OP_NEG, OP_ABS,
  OP_MIN, OP_MAX, OP_WHERE, OP_EQ, OP_NE, OP_LT, OP_LE, OP_GT, OP_GE,
  OP_LAND, OP_LOR, OP_LXOR, OP_LNOT, OP_BAND, OP_BOR, OP_BXOR, OP_BNOT,
  OP_CAST
};

// the slots: row g of slot j is element g * stride[j] of in[j] (read) and
// out[j] (written), of dtype type[j]; sepop / septype: the separable
// route's op and dtype per slot
struct K14Args {
  const char* in[K14_MAX_SLOTS];
  char* out[K14_MAX_SLOTS];
  long long stride[K14_MAX_SLOTS];
  int type[K14_MAX_SLOTS];
  int sepop[K14_MAX_SLOTS];
  int septype[K14_MAX_SLOTS];
  int S, nregs;
};

// the program and its constants, in shared memory
struct K14Shared {
  int code[K14_MAX_INSTRS * K14_WORDS];
  int creg[K14_MAX_REGS];
  long long cval[K14_MAX_REGS];
  int out[K14_MAX_SLOTS];
  int nins, ncon;
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

__device__ __noinline__ long long k14_float(int op, bool f32, long long xa,
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
__device__ __noinline__ long long k14_int(int op, int t, long long a,
                                          long long b) {
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

__device__ __noinline__ long long k14_cast(long long x, int from, int to) {
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


// merge(a, b) of one slot by its op (add, min, max, mul) in its dtype:
// k14_float's and k14_int's arithmetic for those four ops
__device__ __forceinline__ long long k14_sep_op(int op, int ty, long long a,
                                                long long b) {
  if (ty == T_F64) {
    const double x = as_d(a), y = as_d(b);
    double r;
    if (op == OP_ADD)
      r = __dadd_rn(x, y);
    else if (op == OP_MUL)
      r = __dmul_rn(x, y);
    else if (x != x || y != y)
      r = __dadd_rn(x, y);
    else if (op == OP_MIN)
      r = y < x ? y : x;
    else
      r = y > x ? y : x;
    return d_bits(r);
  }
  if (ty == T_F32) {
    const float x = as_f(a), y = as_f(b);
    float r;
    if (op == OP_ADD)
      r = __fadd_rn(x, y);
    else if (op == OP_MUL)
      r = __fmul_rn(x, y);
    else if (x != x || y != y)
      r = __fadd_rn(x, y);
    else if (op == OP_MIN)
      r = y < x ? y : x;
    else
      r = y > x ? y : x;
    return f_bits(r);
  }
  typedef unsigned long long u64;
  long long v;
  if (op == OP_ADD)
    v = ty == T_BOOL ? ((a | b) != 0) : (long long)((u64)a + (u64)b);
  else if (op == OP_MUL)
    v = ty == T_BOOL ? (a & b) : (long long)((u64)a * (u64)b);
  else if (op == OP_MIN)
    v = b < a ? b : a;
  else
    v = b > a ? b : a;
  return ty == T_I32 ? (long long)(int)v : v;
}

// the program over this lane's column of the warp's register file Rw
// ([reg][lane]); one copy of the loop, called from every merge site
__device__ __noinline__ void k14_run(const K14Shared& p, long long* Rw,
                                     int lane) {
  for (int k = 0; k < p.nins; ++k) {
    const int* w = p.code + K14_WORDS * k;
    const int op = w[0], ty = w[1];
    const long long x = Rw[w[3] * 32 + lane], y = Rw[w[4] * 32 + lane];
    long long v;
    if (op == OP_CAST)
      v = k14_cast(x, w[5], ty);
    else if (op == OP_WHERE)
      v = x ? y : Rw[w[5] * 32 + lane];
    else if (ty == T_F64 || ty == T_F32)
      v = k14_float(op, ty == T_F32, x, y);
    else
      v = k14_int(op, ty, x, y);
    Rw[w[2] * 32 + lane] = v;
  }
}

// b = merge(a, b) over the S slots.  Separable: each slot by its op.
// Otherwise the program runs on this lane's column of the warp's register
// file Rw ([reg][lane]).
template <int MS, bool SEP>
__device__ __forceinline__ void k14_merge(const K14Args& A,
                                          const K14Shared& p, long long* Rw,
                                          int lane, const long long* a,
                                          long long* b) {
  if (SEP) {
#pragma unroll
    for (int j = 0; j < MS; ++j)
      if (j < A.S) b[j] = k14_sep_op(A.sepop[j], A.septype[j], a[j], b[j]);
    return;
  }
  const int S = A.S;
#pragma unroll
  for (int j = 0; j < MS; ++j)
    if (j < S) {
      Rw[j * 32 + lane] = a[j];
      Rw[(S + j) * 32 + lane] = b[j];
    }
  k14_run(p, Rw, lane);
#pragma unroll
  for (int j = 0; j < MS; ++j)
    if (j < S) b[j] = Rw[p.out[j] * 32 + lane];
}

template <int MS>
__device__ __forceinline__ void k14_store(const K14Args& A, long long row,
                                          const long long* v) {
#pragma unroll
  for (int j = 0; j < MS; ++j)
    if (j < A.S) st_slot(A.out[j], A.type[j], row * A.stride[j], v[j]);
}

template <int MS>
__device__ __forceinline__ void k14_copy(long long* d, const long long* s) {
#pragma unroll
  for (int j = 0; j < MS; ++j) d[j] = s[j];
}

// Inclusive segmented scan across the warp of (f, v): lane l ends with
// the fold of lanes (its run's start in the warp, or 0) .. l, f set when
// that run starts in the warp.  Every lane calls it.
template <int MS, bool SEP>
__device__ __forceinline__ void k14_warp_scan(const K14Args& A,
                                              const K14Shared& p,
                                              long long* Rw, int lane,
                                              bool& f, long long* v) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const bool fo = __shfl_up_sync(DPK_FULL, (int)f, d) != 0;
    long long vo[MS];
#pragma unroll
    for (int j = 0; j < MS; ++j)
      if (j < A.S) vo[j] = __shfl_up_sync(DPK_FULL, v[j], d);
    if (lane >= d) {
      if (!f) k14_merge<MS, SEP>(A, p, Rw, lane, vo, v);
      f = f || fo;
    }
  }
}

// the program (interpreter only) into shared memory and each lane's
// constants into its register column; every thread of the block calls it
__device__ __forceinline__ void k14_load_program(K14Shared& p,
                                                 const long long* pbuf,
                                                 int S, long long* Rw,
                                                 int lane) {
  const int nins = (int)pbuf[0], ncon = (int)pbuf[1];
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
  }
  __syncthreads();
  // constants: registers no instruction writes
  for (int c = 0; c < ncon; ++c) Rw[p.creg[c] * 32 + lane] = p.cval[c];
}

template <int MS>
struct K14Tile {
  static constexpr int C = MS <= 8 ? 8 : 4;     // rows a lane folds a group
  static constexpr int GROUP = 32 * C;
  static constexpr int PITCH = 32 * (C + 1);    // a slot's staged group
};

// Pass 1: grid (ceil(tiles / K14_WARPS), N), a warp a tile.  Per tile x
// of shard s: tflag (a run starts in the tile), tagg (S: the fold of the
// tile's last run), thead (S: the fold of the tile's head run through
// its end, when that run began in an earlier tile and ends here) and
// tend (that end's row, else -1).  Shared memory a warp: the staged
// group (S x PITCH words), then the interpreter's registers (nregs x 32).
template <int MS, bool SEP>
static __global__ void __launch_bounds__(32 * K14_WARPS)
    k14_tiles(K14Args A, const long long* __restrict__ pbuf,
              const unsigned char* __restrict__ flags,
              const int* __restrict__ n0, long long cap, long long tiles,
              long long* tagg, long long* thead, long long* tend,
              unsigned char* tflag) {
  constexpr int C = K14Tile<MS>::C, GROUP = K14Tile<MS>::GROUP;
  constexpr int PITCH = K14Tile<MS>::PITCH;
  extern __shared__ long long sm[];
  __shared__ K14Shared p;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = A.S;
  long long* X = sm + (long long)warp * (S * PITCH + (SEP ? 0 : A.nregs * 32));
  long long* Rw = X + S * PITCH;
  if (!SEP) k14_load_program(p, pbuf, S, Rw, lane);
  const long long tile = (long long)blockIdx.x * K14_WARPS + warp;
  const int s = blockIdx.y;
  const long long nv = n0[s];
  const long long r0 = tile * K14_TILE;
  if (tile >= tiles || r0 >= nv) return;  // k14_carry reads only these
  const long long base = (long long)s * cap;
  long long cv[MS], hv[MS];
  bool cf = false, chas = false;  // the open run began in the tile; any
  long long hend = -1;
  for (int it = 0; it < K14_TILE / GROUP; ++it) {
    const long long g0 = r0 + (long long)it * GROUP;
    if (g0 >= nv) break;
    // the group's run starts, row k * 32 + lane in ballot k (past n a row
    // resets: nothing after it is valid), then this lane's C rows' bits
    unsigned char fl[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const long long g = g0 + k * 32 + lane;
      fl[k] = g < nv ? __ldg(flags + base + g) : 1;
    }
    unsigned ball[C];
#pragma unroll
    for (int k = 0; k < C; ++k)
      ball[k] = __ballot_sync(DPK_FULL,
                              fl[k] != 0 || g0 + k * 32 + lane == 0);
    // slot j, row k * 32 + lane, lands at r + r / C of its staged group;
    // the C loads of a slot are issued together (one branch on the dtype
    // a slot, not a load)
#pragma unroll
    for (int j = 0; j < MS; ++j) {
      if (j >= S) continue;
      const int ty = A.type[j];
      const long long st = A.stride[j];
      long long v[C];
      if (ty == T_I32 || ty == T_F32) {
        const int* q = (const int*)A.in[j];
#pragma unroll
        for (int k = 0; k < C; ++k) {
          const long long g = g0 + k * 32 + lane;
          const int x = g < nv ? __ldg(q + (base + g) * st) : 0;
          v[k] = ty == T_I32 ? (long long)x : (long long)(unsigned)x;
        }
      } else if (ty == T_BOOL) {
        const unsigned char* q = (const unsigned char*)A.in[j];
#pragma unroll
        for (int k = 0; k < C; ++k) {
          const long long g = g0 + k * 32 + lane;
          v[k] = g < nv ? (long long)(__ldg(q + (base + g) * st) != 0) : 0;
        }
      } else {
        const long long* q = (const long long*)A.in[j];
#pragma unroll
        for (int k = 0; k < C; ++k) {
          const long long g = g0 + k * 32 + lane;
          v[k] = g < nv ? __ldg(q + (base + g) * st) : 0;
        }
      }
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int r = k * 32 + lane;
        X[j * PITCH + r + r / C] = v[k];
      }
    }
    unsigned word = 0;
#pragma unroll
    for (int k = 0; k < C; ++k)
      if (k == (lane * C) >> 5) word = ball[k];
    const unsigned sm_ = (word >> ((lane * C) & 31)) & ((1u << C) - 1u);
    // run ends: the next row starts a run (the next lane's first row; for
    // lane 31 the next group's), over this lane's valid rows
    const long long gl = g0 + (long long)lane * C;
    const long long gn = g0 + GROUP;
    unsigned nxt = __shfl_down_sync(DPK_FULL, sm_ & 1u, 1);
    if (lane == 31) nxt = gn >= nv || __ldg(flags + base + gn) != 0;
    const unsigned vm = gl >= nv ? 0u
                        : gl + C <= nv ? (1u << C) - 1u
                                       : (1u << (int)(nv - gl)) - 1u;
    const unsigned em = ((sm_ >> 1) | (nxt << (C - 1))) & vm;
    __syncwarp();
    // fold the chunk; the head run (begun before the chunk) ends at the
    // chunk's first end unless its first row starts a run
    const long long* xs = X + lane * (C + 1);
    long long acc[MS], lh[MS];
    bool seen = sm_ & 1u;
#pragma unroll
    for (int j = 0; j < MS; ++j) acc[j] = j < S ? xs[j * PITCH] : 0;
#pragma unroll 1
    for (int k = 0; k < C; ++k) {
      if (k > 0) {
        long long b[MS];
#pragma unroll
        for (int j = 0; j < MS; ++j) b[j] = j < S ? xs[j * PITCH + k] : 0;
        if ((sm_ >> k) & 1u) {
          seen = true;
        } else {
          k14_merge<MS, SEP>(A, p, Rw, lane, acc, b);
        }
        k14_copy<MS>(acc, b);
      }
      if ((em >> k) & 1u) {
        if (seen)
          k14_store<MS>(A, base + gl + k, acc);
        else
          k14_copy<MS>(lh, acc);
      }
    }
    __syncwarp();  // the staged group is read: the next may land
    const int hk = (sm_ & 1u) ? -1 : (em ? __ffs(em) - 1 : -1);
    bool f = sm_ != 0;
    k14_warp_scan<MS, SEP>(A, p, Rw, lane, f, acc);
    bool ft = f;  // the open run at the chunk's end began in the tile
    if (!f && chas) {
      k14_merge<MS, SEP>(A, p, Rw, lane, cv, acc);
      ft = cf;
    }
    // the exclusive carry of this lane's chunk: lane - 1's, lane 0's the
    // carry of the tile's earlier groups
    long long e[MS];
#pragma unroll
    for (int j = 0; j < MS; ++j)
      if (j < S) e[j] = __shfl_up_sync(DPK_FULL, acc[j], 1);
    bool fe = __shfl_up_sync(DPK_FULL, (int)ft, 1) != 0, he = true;
    if (lane == 0) {
      k14_copy<MS>(e, cv);
      fe = cf;
      he = chas;
    }
    if (hk >= 0) {
      if (he) k14_merge<MS, SEP>(A, p, Rw, lane, e, lh);
      if (he && fe) {
        k14_store<MS>(A, base + gl + hk, lh);
      } else {
        // the tile's head run ends here: it needs the earlier tiles
        hend = gl + hk;
        k14_copy<MS>(hv, lh);
      }
    }
#pragma unroll
    for (int j = 0; j < MS; ++j)
      if (j < S) cv[j] = __shfl_sync(DPK_FULL, acc[j], 31);
    cf = __shfl_sync(DPK_FULL, (int)ft, 31) != 0;
    chas = true;
  }
  const long long xt = (long long)s * tiles + tile;
  const unsigned who = __ballot_sync(DPK_FULL, hend >= 0);
  if (hend >= 0) {
    tend[xt] = hend;
#pragma unroll
    for (int j = 0; j < MS; ++j)
      if (j < S) thead[xt * S + j] = hv[j];
  }
  if (lane == 0) {
    if (who == 0) tend[xt] = -1;
    tflag[xt] = cf;
#pragma unroll
    for (int j = 0; j < MS; ++j)
      if (j < S) tagg[xt * S + j] = cv[j];
  }
}

// Pass 2: a warp a shard over its tiles, 32 at a time: each tile's carry
// is the (segmented) fold of the tiles before it.
template <int MS, bool SEP>
static __global__ void __launch_bounds__(32)
    k14_carry(K14Args A, const long long* __restrict__ pbuf,
              const int* __restrict__ n0, long long cap, long long tiles,
              const long long* __restrict__ tagg,
              const long long* __restrict__ thead,
              const long long* __restrict__ tend,
              const unsigned char* __restrict__ tflag) {
  extern __shared__ long long sm[];
  __shared__ K14Shared p;
  const int lane = threadIdx.x;
  long long* Rw = sm;
  if (!SEP) k14_load_program(p, pbuf, A.S, Rw, lane);
  const int s = blockIdx.x;
  const long long nt = (n0[s] + K14_TILE - 1) / K14_TILE;
  if (nt <= 1) return;
  const long long base = (long long)s * cap;
  long long cv[MS];
  bool chas = false;  // tile 0 starts a run, so every later tile has one
  for (long long u0 = 0; u0 < nt; u0 += 32) {
    const long long u = u0 + lane;
    const bool has = u < nt;
    const long long x = (long long)s * tiles + (has ? u : 0);
    bool f = !has || tflag[x] != 0;
    long long v[MS], h[MS];
#pragma unroll
    for (int j = 0; j < MS; ++j) {
      v[j] = has && j < A.S ? tagg[x * A.S + j] : 0;
      h[j] = 0;
    }
    const long long e = has ? tend[x] : -1;
    if (e >= 0) {
#pragma unroll
      for (int j = 0; j < MS; ++j)
        if (j < A.S) h[j] = thead[x * A.S + j];
    }
    k14_warp_scan<MS, SEP>(A, p, Rw, lane, f, v);
    if (!f && chas) k14_merge<MS, SEP>(A, p, Rw, lane, cv, v);
    // the exclusive carry of tile u: lane - 1's inclusive, lane 0's the
    // carry of the earlier groups
    long long c[MS];
#pragma unroll
    for (int j = 0; j < MS; ++j) {
      c[j] = __shfl_up_sync(DPK_FULL, v[j], 1);
      if (lane == 0) c[j] = cv[j];
    }
    if (e >= 0) {
      k14_merge<MS, SEP>(A, p, Rw, lane, c, h);
      k14_store<MS>(A, base + e, h);
    }
#pragma unroll
    for (int j = 0; j < MS; ++j) cv[j] = __shfl_sync(DPK_FULL, v[j], 31);
    chas = true;
  }
}

template <int MS, bool SEP>
static int k14_launch(const K14Args& A, const long long* pbuf,
                      const unsigned char* flags, const int* n, int N,
                      long long cap, long long tiles, long long* tagg,
                      long long* thead, long long* tend, unsigned char* tflag,
                      cudaStream_t st) {
  const size_t smem1 =
      (size_t)(A.S * K14Tile<MS>::PITCH + (SEP ? 0 : A.nregs * 32)) * 8 *
      K14_WARPS;
  const size_t smem2 = SEP ? 0 : (size_t)A.nregs * 32 * 8;
  cudaError_t err = cudaFuncSetAttribute(
      k14_tiles<MS, SEP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (tiles + K14_WARPS - 1) / K14_WARPS;
  k14_tiles<MS, SEP><<<dim3((unsigned)blocks, (unsigned)N), 32 * K14_WARPS,
                       smem1, st>>>(A, pbuf, flags, n, cap, tiles, tagg,
                                    thead, tend, tflag);
  err = cudaGetLastError();
  if (err != cudaSuccess || tiles <= 1) return (int)err;
  k14_carry<MS, SEP><<<N, 32, smem2, st>>>(A, pbuf, n, cap, tiles, tagg,
                                           thead, tend, tflag);
  return (int)cudaGetLastError();
}


// The body of a C entry whose library holds the slot bounds MS0 (for S <=
// MS0) and MS1 (for MS0 < S <= MS1).  in / out: S slot pointers (a leaf's
// data pointer plus its lane offset); types: the slots' dtype codes;
// strides: each slot's lanes per row.  pbuf: the device program
// (merge_program.Program.words); nregs: its register count; sep: null,
// or the separable (op, dtype) of each slot (2S ints).  flags: (N, cap)
// bool run starts; n: (N,) valid rows.  scratch: at least
// dpk_segmented_merge_scratch(N, cap, S) bytes.
static long long k14_scratch(int N, long long cap, int S) {
  const long long nt = (long long)N * ((cap + K14_TILE - 1) / K14_TILE);
  return nt * (2 * S + 1) * 8 + (nt + 7) / 8 * 8;
}

template <int MS0, int MS1>
static int k14_entry(const void* const* in, void* const* out,
                     const int* types, const long long* strides, int S,
                     const long long* pbuf, int nregs, const int* sep,
                     const unsigned char* flags, const int* n, int N,
                     long long cap, void* scratch, long long scratch_bytes,
                     void* stream) {
  if (S < 1 || S > MS1 || N < 1 || N > 65535 || nregs < 2 * S ||
      nregs > K14_MAX_REGS)
    return (int)cudaErrorInvalidValue;
  if (cap == 0) return (int)cudaGetLastError();
  if (scratch_bytes < k14_scratch(N, cap, S))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  K14Args A;
  for (int j = 0; j < K14_MAX_SLOTS; ++j) {
    A.in[j] = j < S ? (const char*)in[j] : nullptr;
    A.out[j] = j < S ? (char*)out[j] : nullptr;
    A.stride[j] = j < S ? strides[j] : 0;
    A.type[j] = j < S ? types[j] : T_I64;
    A.sepop[j] = sep != nullptr && j < S ? sep[2 * j] : 0;
    A.septype[j] = sep != nullptr && j < S ? sep[2 * j + 1] : 0;
  }
  A.S = S;
  A.nregs = nregs;
  const long long tiles = (cap + K14_TILE - 1) / K14_TILE;
  const long long nt = (long long)N * tiles;
  long long* tagg = (long long*)scratch;
  long long* thead = tagg + nt * S;
  long long* tend = thead + nt * S;
  unsigned char* tflag = (unsigned char*)(tend + nt);
#define K14_LAUNCH(MS, SEP)                                              \
  return k14_launch<MS, SEP>(A, pbuf, flags, n, N, cap, tiles, tagg,     \
                             thead, tend, tflag, st)
  if (sep != nullptr) {
    if (S <= MS0) K14_LAUNCH(MS0, true);
    K14_LAUNCH(MS1, true);
  }
  if (S <= MS0) K14_LAUNCH(MS0, false);
  K14_LAUNCH(MS1, false);
#undef K14_LAUNCH
}
