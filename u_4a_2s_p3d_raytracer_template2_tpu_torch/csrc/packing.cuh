// Packing the live slots of a query, shared by the brute-force kernels
// (brute_intersect.cu: a count and a scatter launch before the sweep) and
// the BVH walk (bvh_walk.cu: inside the walk's own launch): a ballot and a
// prefix over a block's threads, which keep the live slots in slot order.
#pragma once

// The number of this thread's block-mates before it (in thread order) whose
// `live` is set, and in `total` the block's count. Every thread of the
// block, kWarps warps, calls it; s_count holds kWarps ints and may be
// reused by the next call.
template <int kWarps>
__device__ __forceinline__ int block_prefix(bool live, int* s_count,
                                            int& total) {
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  __syncthreads();  // every thread has read the previous call's s_count
  if (lane == 0) s_count[warp] = __popc(ballot);
  __syncthreads();
  int at = __popc(ballot & ((1u << lane) - 1));
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    at += w < warp ? s_count[w] : 0;
    total += s_count[w];
  }
  return at;
}
