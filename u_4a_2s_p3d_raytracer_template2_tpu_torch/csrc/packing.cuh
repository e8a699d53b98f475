// Packing the live slots of a query, shared by the brute-force kernels
// (brute_intersect.cu: a count and a scatter launch before the sweep), the
// BVH walk (bvh_walk.cu) and the per-ray traversals (perray_traverse.cu),
// these two inside their own launch (for_live_slots): a ballot and a
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

// Calls on_dead(slot) for each slot of the block's kThreads slots that
// `dead` marks (none when it is null), and on_live(slot) for each other
// slot, the live slots packed in slot order into the block's first threads
// (block_prefix); the warps left without a slot end at once. Every thread
// of the block, kThreads of them, calls it.
template <int kThreads, class Dead, class Live>
__device__ __forceinline__ void for_live_slots(int n_slots,
                                               const uint8_t* __restrict__ dead,
                                               Dead on_dead, Live on_live) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int s_queue[kThreads];
  __shared__ int s_count[kWarps];
  const int mine = blockIdx.x * kThreads + threadIdx.x;
  const bool in = mine < n_slots;
  const bool live = in && !(dead && dead[mine]);
  if (in && !live) on_dead(mine);
  int queued;
  const int at = block_prefix<kWarps>(live, s_count, queued);
  if (live) s_queue[at] = mine;
  __syncthreads();
  if (threadIdx.x < queued) {
    const int slot = s_queue[threadIdx.x];
    on_live(slot);
  }
}
