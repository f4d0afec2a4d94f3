// The global library of K1: straight_frames.cu's frame loop in the global
// layout (straight_global.cuh: one env a cluster of up to 16 blocks of up
// to 512 threads, its rows in a slab of global memory), for the straight
// scenes one block cannot hold, past 1024 slots or past a block's 227 KB
// of shared memory, up to 8192 slots.  Entries: straight_frames_global (the
// block entry's arguments and the slab, frames_env_words floats an env),
// straight_frames_global_words (the slab's words an env) and
// straight_frames_cluster_fit (the launch's occupancy question).  A library
// of its own, so that nvcc builds it beside the others and the block
// library stays as it is.

#include "straight_frames.cu"

template <bool kLinear, bool kObjects>
__global__ void __launch_bounds__(STRAIGHT_GLOBAL_THREADS)
    straight_frames_global_kernel(const __grid_constant__ Fields f, const uint8_t* mask,
                                  const __grid_constant__ Geo g,
                                  const __grid_constant__ Params p, int V, int frames,
                                  float* slab) {
  frames_body<kLinear, true, kObjects>(f, mask, g, p, V, frames, slab);
}

// The global K1's instantiation of variant (bit 0: the Linear rows', bit 1:
// the objects one)
static auto global_instantiation(int variant) {
  return pick_instantiation(variant & 1, variant & 2, straight_frames_global_kernel<false, false>,
                            straight_frames_global_kernel<true, false>,
                            straight_frames_global_kernel<false, true>,
                            straight_frames_global_kernel<true, true>);
}

extern "C" int straight_frames_global(STRAIGHT_FIELD_PARAMS, const uint8_t* mask, float* slab,
                                      const Geo* geo, const Params* params, int B, int V,
                                      int frames, void* stream) {
  const Fields f = STRAIGHT_FIELDS;
  const int variant = (params->linear ? 1 : 0) | (params->objects ? 2 : 0);
  return launch_global(global_instantiation(variant), variant, B, V, geo->n_lanes, stream, f,
                       mask, *geo, *params, V, frames, slab);
}

// The words of one env's slab at V slots and L lanes (what
// ops/straight_frames.py::global_words is held to).
extern "C" long long straight_frames_global_words(int V, int L) {
  return frames_env_words(global_blocks(V) * global_threads(V), L);
}

// Clusters of `blocks` blocks of `threads` threads of the variant
// instantiation (as straight_frames_global picks it) the card holds at once
// (tools/cluster_fit.py); -1 on an error.
extern "C" int straight_frames_cluster_fit(int blocks, int threads, int L, int variant) {
  return global_cluster_fit(global_instantiation(variant), blocks, threads, L);
}
