// K14 segmented_merge for 7 to 16 slots (the slot bound 16), built as a
// library of its own beside segmented_merge.cu so that the two build in
// parallel; the device code and its design: segmented_merge.cuh.
#include "segmented_merge.cuh"

// arguments: k14_entry (segmented_merge.cuh); S <= 16
extern "C" int dpk_segmented_merge_wide(
    const void* const* in, void* const* out, const int* types,
    const long long* strides, int S, const long long* pbuf, int nregs,
    const int* sep, const unsigned char* flags, const int* n, int N,
    long long cap, void* scratch, long long scratch_bytes, void* stream) {
  return k14_entry<16, 16>(in, out, types, strides, S, pbuf, nregs, sep,
                           flags, n, N, cap, scratch, scratch_bytes, stream);
}
