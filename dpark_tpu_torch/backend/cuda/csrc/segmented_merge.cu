// K14 segmented_merge for up to 6 slots (the slot bounds 2 and 6); the
// device code and its design: segmented_merge.cuh.
#include "segmented_merge.cuh"

// scratch of dpk_segmented_merge and dpk_segmented_merge_wide: per tile
// of K14_TILE rows S + S + 1 int64 words and a flag byte (8-byte aligned)
extern "C" long long dpk_segmented_merge_scratch(int N, long long cap,
                                                 int S) {
  return k14_scratch(N, cap, S);
}

// arguments: k14_entry (segmented_merge.cuh); S <= 6
extern "C" int dpk_segmented_merge(const void* const* in, void* const* out,
                                   const int* types,
                                   const long long* strides, int S,
                                   const long long* pbuf, int nregs,
                                   const int* sep, const unsigned char* flags,
                                   const int* n, int N, long long cap,
                                   void* scratch, long long scratch_bytes,
                                   void* stream) {
  return k14_entry<2, 6>(in, out, types, strides, S, pbuf, nregs, sep, flags,
                         n, N, cap, scratch, scratch_bytes, stream);
}
