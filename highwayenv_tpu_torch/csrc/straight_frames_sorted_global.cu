// The global library of K3: straight_frames_sorted.cu's frame loop in the
// global layout (straight_global.cuh: one env a cluster of up to 16 blocks
// of up to 512 threads, its rows in a slab of global memory), for the
// straight scenes one block cannot hold, past 1024 slots or past a block's
// 227 KB of shared memory, up to 8192 slots.  The in-warp scans are the
// block layout's; a query joins the warp totals of every later (earlier)
// warp of the env, whichever block wrote them, with the same 64-bit (s,
// rank) key and tie rules, and the band windows read their partners' rows
// at ranks r +- W and r +- Wn wherever they lie, after the stage's barrier.
// Each block votes its env's two flags into the slab; the env's first
// thread joins the votes after one more barrier.  Entries:
// straight_frames_sorted_global (the block entry's arguments and the slab,
// sorted_env_words floats an env), straight_frames_sorted_global_words and
// straight_frames_sorted_cluster_fit.  A library of its own, so that nvcc
// builds it beside the others and the block library stays as it is.

#include "straight_frames_sorted.cu"

template <bool kLinear>
__global__ void __launch_bounds__(STRAIGHT_GLOBAL_THREADS)
    straight_frames_sorted_global_kernel(const __grid_constant__ Fields f, const int* idx,
                                         uint8_t* flags, const __grid_constant__ Geo g,
                                         const __grid_constant__ Params p, int V, int frames,
                                         int W, int Wn, float* slab) {
  frames_sorted_body<kLinear, true>(f, idx, flags, g, p, V, frames, W, Wn, slab);
}

extern "C" int straight_frames_sorted_global(STRAIGHT_FIELD_PARAMS, const int* idx,
                                             uint8_t* flags, float* slab, const Geo* geo,
                                             const Params* params, int B, int V, int frames,
                                             int W, int Wn, void* stream) {
  const Fields f = STRAIGHT_FIELDS;
  auto kernel = params->linear ? straight_frames_sorted_global_kernel<true>
                               : straight_frames_sorted_global_kernel<false>;
  return launch_global(kernel, params->linear, B, V, geo->n_lanes, stream, f, idx, flags,
                       *geo, *params, V, frames, W, Wn, slab);
}

// The words of one env's slab at V slots and L lanes (what
// ops/straight_frames.py::global_words is held to).
extern "C" long long straight_frames_sorted_global_words(int V, int L) {
  return sorted_env_words(global_blocks(V) * global_threads(V), L, global_blocks(V));
}

// Clusters of `blocks` blocks of `threads` threads the card holds at once
// (tools/cluster_fit.py); -1 on an error.
extern "C" int straight_frames_sorted_cluster_fit(int blocks, int threads, int L, int linear) {
  return global_cluster_fit(linear ? straight_frames_sorted_global_kernel<true>
                                   : straight_frames_sorted_global_kernel<false>,
                            blocks, threads, L);
}
