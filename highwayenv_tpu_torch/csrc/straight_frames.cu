// All frames of one policy step on a straight multi-lane road, dense: one
// thread block per env and one thread per vehicle slot.
//
// Replaces the TPU kernel highwayenv_tpu/ops/straight_pallas_bm.py::
// build_pallas_frame(sorted_mode=False) (pallas_call at :1190, frame body
// _frame_body :545-1117): the dense frame megakernel.  Semantics are those of
// ops/straight_frames.py::frames_plain, its plain torch version; the frame's
// phases other than the two pair searches live in straight_common.cuh,
// shared with the sorted kernel.
//
// Four instantiations, by Params::linear and Params::objects.  The lean ones
// (objects off) resolve a collision as the TPU kernel's lean branch does,
// every pair between two vehicles, and trap on an obstacle or landmark row.
// The objects ones (the TPU kernel's non-lean branch, _frame_body
// :567-579, :591-595, :993-1019, :1066-1102; the env path of an env made
// with lean=False) stage each slot's solid and obstacle bits once a launch
// (PostRow::obj) and resolve each pair by the object rule of
// ops/collision.py, as the general kernel K4 does: a pair crashes and
// pushes only where both members are solid; the push is the full
// translation against an obstacle and half of it between two vehicles; an
// obstacle records no push of its own, so the last-write rule runs over
// the pairs where the slot writes; a non-solid slot (a landmark) that
// intersects a partner is marked hit (Params::hit / hit_out).  The gate,
// the sphere pre-check and the SAT walk are the lean code's.
//
// On the sorted main path (ops/straight_sorted.py::simulate_bm_sorted) it is
// the per-env exact fallback: given a mask, a block whose env has no flag
// returns at once, before any barrier, and a block whose env has one writes
// the dense result over the banded row the caller put in the output
// tensors.  Without a mask every env runs.
//
// What bounds it on an H100: not float operations (~2.97e9 a highway-v0
// step at B = 4096, 0.044 ms at the float32 peak) and not bytes (~26 MB),
// but issue slots and the latency of dependent shared-memory loads.  On the
// earlier design, which tested every column for lane membership and every
// slot against the collision gate, thread 0's clock64() split of a
// highway-v0 frame (V = 51, tools/kernel_ab.py --clocks) was 28% neighbour
// search, 42% drive(), 25% collision pass, 61k cycles a frame at 92
// registers.  What this design does about it: the neighbour search visits
// only the members of its three query lanes (the set bits of the lane
// ballots, ascending: front `<=` keeps the last column, rear strict `>`
// the first, as the dense scan); the collision pass tests each pair's
// sphere pre-check once, at the slot half way behind it on the circle of
// slots (i tests i + 1 .. i + V / 2, mod V; at even V the pair V / 2 apart
// twice, to the same result), among the partners that pass the gate
// words, and a pair within reach sets its bit in both members' words
// (shared-memory atomicOr, one barrier); each member then runs the swept
// SAT of its pairs in ascending partner order, in the pair's (lower,
// upper) orientation, so both get the same result and the last-write
// impact rule resolves with no exchange; the shared frame code
// (straight_common.cuh) does the rest.

#include "straight_common.cuh"
#include "straight_global.cuh"

// The words of one env's rows and pre-check bits at n threads (its slots
// rounded up to a warp, a block's or in the global layout the env's
// cluster's) and L lanes: the rows and a word of pre-check bits per warp
// per thread, and the ballot words per warp.  The global layout's slab
// holds this many an env, rounded up to 4 (16-byte-aligned rows).
__host__ __device__ __forceinline__ long long frames_env_words(int n, int L) {
  const long long w = static_cast<long long>(ROW_WORDS + n / 32) * n +
                      static_cast<long long>(WARP_WORDS(L)) * (n / 32);
  return (w + 3) & ~3ll;
}

// The frame loop of one env, its rows in the block's shared memory or, in
// the global layout (kGlobal, straight_global.cuh), in its slab of global
// memory at slab + env * frames_env_words, the env a cluster of blocks;
// kObjects: the objects instantiation (obstacle and landmark rows).
template <bool kLinear, bool kGlobal, bool kObjects>
__device__ __forceinline__ void frames_body(const Fields& f, const uint8_t* mask, const Geo& g,
                                            const Params& p, int V, int frames, float* slab) {
  const Place at = place<kGlobal>();
  if (mask != nullptr && mask[at.env] == 0) return;  // every block of the env
  extern __shared__ __align__(16) float smem[];
  const int N = at.n;
  const int L = g.n_lanes;
  load_lane_offsets(g);
  Rows r;
  float* rows = kGlobal ? slab + at.env * frames_env_words(N, L) : smem + lane_offset_words(L);
  // per slot, its partners whose pair passed the sphere pre-check, [N][N / 32]
  unsigned* near = reinterpret_cast<unsigned*>(r.carve(rows, N, L));
  // the view through which this block writes its warps' ballot words
  const Rows rb = kGlobal ? r.at_warp(at.warp0) : r;

  const int i = at.i;
  const bool live = i < V;
  const size_t o = static_cast<size_t>(at.env) * V + i;
  typename SlotOf<kLinear>::type v;
  if (live) v.load(f, o);
  v.derive();
  r.post[i].len = v.len;
  r.post[i].wid = v.wid;
  bool hit = false;  // kObjects: the slot's hit flag
  if constexpr (kObjects) {
    if (live) hit = p.hit[o] != 0;
    const bool solid = v.active() && v.kind != KIND_LANDMARK;
    r.post[i].obj = (solid ? F_SOLID : 0) | (v.kind == KIND_OBSTACLE ? F_OBSTACLE : 0);
  }
  env_sync<kGlobal>();  // the lane offsets are loaded

  for (int frame = 0; frame < frames; ++frame) {
    const Start st = frame_start(v, g);
    stage_start(rb, i, live, v, st, g);
    env_sync<kGlobal>();

    if (live) {
      // --- neighbours on the own lane and lanes -1 / +1: the members ------
      float f_key[3] = {INFINITY, INFINITY, INFINITY};
      float r_key[3] = {-INFINITY, -INFINITY, -INFINITY};
      int f_idx[3] = {-1, -1, -1};
      int r_idx[3] = {-1, -1, -1};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const unsigned* memb = r.memb(clampi(query_lane(v.lane, k, L), 0, L - 1));
        visit_bits([&](int w) { return memb[w]; }, 0, V - 1, i, [&](int col) {
          const float sc = r.s(col);
          // front: smallest s_c >= s, the last column among ties
          if (st.s <= sc && sc <= f_key[k]) {
            f_key[k] = sc;
            f_idx[k] = col;
          }
          // rear: largest s_c < s, the first column among ties
          if (sc < st.s && sc > r_key[k]) {
            r_key[k] = sc;
            r_idx[k] = col;
          }
        });
      }
      drive(v, st, f_idx, r_idx, r, i, V, g, p);
    }

    // cleared after the last frame's SATs, set only after the next barrier
    unsigned* mine = near + i * r.nw;
    for (int w = 0; w < r.nw; ++w) mine[w] = 0u;
    stage_post(rb, i, live, v);
    env_sync<kGlobal>();

    // --- collisions: each pair's sphere pre-check once, half way round ------
    // slot i tests the slots i + 1 .. i + V / 2 (mod V) that pass its gate,
    // and a pair within reach sets its bit in both members' words
    if (live) {
      const float4 me = r.pose(i);
      const bool ac = v.active() && v.coll;
      auto gate = [&](int w) { return gate_word(r, w, ac, v.is_vehicle(), v.chk); };
      auto test = [&](int j) {
        const float4 other = r.pose(j);
        if (i < j ? within_reach(me, other, me.z, p) : within_reach(other, me, other.z, p)) {
          atomicOr(mine + (j >> 5), 1u << (j & 31));
          atomicOr(near + j * r.nw + (i >> 5), 1u << (i & 31));
        }
      };
      const int half = i + V / 2;
      visit_bits(gate, i + 1, min(half, V - 1), i, test);
      if (half >= V) visit_bits(gate, 0, half - V, i, test);
    }
    env_sync<kGlobal>();

    // --- collisions: the swept SATs of the pairs that passed, impacts -------
    if (live) {
      bool any_inter = false;
      int row_j = -1, col_j = -1;
      float row_tx = 0.f, row_ty = 0.f, col_tx = 0.f, col_ty = 0.f;
      const int me_obj = kObjects ? r.post[i].obj : 0;
      visit_bits([&](int w) { return mine[w]; }, 0, V - 1, i, [&](int j) {
        const bool lower = i < j;  // this slot is the pair's ``self``
        bool inter, will;
        float tx, ty;
        sat_pair(r, p, lower ? i : j, lower ? j : i, &inter, &will, &tx, &ty);
        if constexpr (kObjects) {
          // both solid: a crash, and a push unless this slot is an
          // obstacle; a non-solid slot that intersects is hit
          const int obj = r.post[j].obj;
          const bool both = (me_obj & obj & F_SOLID) != 0;
          any_inter = any_inter || (inter && both);
          hit = hit || (inter && !(me_obj & F_SOLID));
          if (will && both && !(me_obj & F_OBSTACLE)) {
            const bool obstacle = (obj & F_OBSTACLE) != 0;
            if (lower) {
              row_j = j;
              row_tx = (obstacle ? 1.0f : 0.5f) * tx;
              row_ty = (obstacle ? 1.0f : 0.5f) * ty;
            } else {
              col_j = j;
              col_tx = (obstacle ? 1.0f : -0.5f) * tx;
              col_ty = (obstacle ? 1.0f : -0.5f) * ty;
            }
          }
          return;
        }
        any_inter = any_inter || inter;
        if (will) {
          // ascending j: the last write is the max-index partner
          if (lower) {
            row_j = j;
            row_tx = 0.5f * tx;
            row_ty = 0.5f * ty;
          } else {
            col_j = j;
            col_tx = -0.5f * tx;
            col_ty = -0.5f * ty;
          }
        }
      });
      if (row_j >= 0) {
        v.ix = row_tx;
        v.iy = row_ty;
      } else if (col_j >= 0) {
        v.ix = col_tx;
        v.iy = col_ty;
      }
      v.pend = v.pend || row_j >= 0 || col_j >= 0;
      v.crashed = v.crashed || any_inter;
    }
  }

  trap_on_kinds<kLinear, kObjects>(live, v.kind);
  if (live) v.store(f, o);
  if (kObjects && live) p.hit_out[o] = hit ? 1 : 0;
}

template <bool kLinear, bool kObjects>
__global__ void __launch_bounds__(MAX_BLOCK_THREADS)
    straight_frames_kernel(const __grid_constant__ Fields f, const uint8_t* mask,
                           const __grid_constant__ Geo g, const __grid_constant__ Params p,
                           int V, int frames) {
  frames_body<kLinear, false, kObjects>(f, mask, g, p, V, frames, nullptr);
}

// The instantiation of a frame kernel template K<kLinear, kObjects> that a
// launch asks: the Linear rows' where Linear rows are possible
// (Params::linear), the objects one where obstacle and landmark rows are
// (Params::objects)
template <typename Kernel>
Kernel pick_instantiation(bool linear, bool objects, Kernel lean_idm, Kernel lean_linear,
                          Kernel objects_idm, Kernel objects_linear) {
  if (objects) return linear ? objects_linear : objects_idm;
  return linear ? lean_linear : lean_idm;
}

extern "C" int straight_frames(STRAIGHT_FIELD_PARAMS, const uint8_t* mask, const Geo* geo,
                               const Params* params, int B, int V, int frames, void* stream) {
  const Fields f = STRAIGHT_FIELDS;
  // per thread: the rows and a word of pre-check bits per warp
  auto kernel = pick_instantiation(params->linear, params->objects,
                                   straight_frames_kernel<false, false>,
                                   straight_frames_kernel<true, false>,
                                   straight_frames_kernel<false, true>,
                                   straight_frames_kernel<true, true>);
  return launch_per_env(kernel, B, V, geo->n_lanes, ROW_WORDS + (V + 31) / 32,
                        WARP_WORDS(geo->n_lanes), stream, f, mask, *geo, *params, V, frames);
}

// The shared memory a block of straight_frames asks at V slots and L lanes
// (what ops/straight_frames.py::launch_smem is held to).
extern "C" long long straight_frames_smem_bytes(int V, int L) {
  return static_cast<long long>(frames_smem(V, L, ROW_WORDS + (V + 31) / 32, WARP_WORDS(L)));
}
