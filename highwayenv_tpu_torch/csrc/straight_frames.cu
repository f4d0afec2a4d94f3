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
// On the sorted main path (ops/straight_sorted.py::simulate_bm_sorted) it is
// the per-env exact fallback: given a mask, a block whose env has no flag
// returns at once, and a block whose env has one writes the dense result over
// the banded row the caller put in the output tensors.  Without a mask every
// env runs.
//
// What bounds it on an H100: float32 arithmetic on slot pairs.  Per frame
// each slot scans every other slot for its front/rear neighbours on three
// lanes and for MOBIL abort conflicts, and runs the swept rectangle SAT
// against the slots within collision reach: O(V^2) float work per env and
// frame, against ~6.3 KB of state read and written per env and policy step
// (V = 51): about 0.7 M float operations per env-step against 6.3 KB, far
// above the card's ~20 operations per byte, so operations bound it.
// What the design does about it: the env's fields stay in shared memory for
// all frames (one pass over device memory per policy step); each thread
// keeps its own slot in registers and fetches neighbour rows by index; SAT
// runs only for pairs that pass the sphere pre-check.  Both members of a
// pair evaluate it (no atomics), so the last-write impact rule resolves in a
// fixed order.

#include "straight_common.cuh"

__global__ void straight_frames_kernel(Fields f, const uint8_t* mask, Geo g,
                                       Params p, int V, int frames) {
  if (mask != nullptr && mask[blockIdx.x] == 0) return;  // the whole block
  extern __shared__ float smem[];
  const int N = blockDim.x;
  StartRows r;
  PostRows c;
  c.carve(r.carve(smem, N), N);

  const int i = threadIdx.x;
  const bool live = i < V;
  const size_t o = static_cast<size_t>(blockIdx.x) * V + i;
  Slot v;
  if (live) v.load(f, o);
  c.len[i] = v.len;
  c.wid[i] = v.wid;
  c.diag[i] = sqrtf(v.len * v.len + v.wid * v.wid);

  for (int frame = 0; frame < frames; ++frame) {
    const Start st = frame_start(v, g);
    stage_start(r, i, live, v, st);
    __syncthreads();

    if (live) {
      // --- neighbours on the own lane and lanes -1 / +1 -------------------
      float f_key[3] = {INFINITY, INFINITY, INFINITY};
      float r_key[3] = {-INFINITY, -INFINITY, -INFINITY};
      int f_idx[3] = {-1, -1, -1};
      int r_idx[3] = {-1, -1, -1};
      for (int col = 0; col < V; ++col) {
        if (col == i || !(r.flags[col] & F_OCCUPIABLE)) continue;
        const float sc = r.s[col], lc = r.lat[col];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          if (fabsf(lc - st.q_off[k]) <= g.member_tol) {
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
          }
        }
      }
      Row front[3], rear[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        front[k] = r.fetch(f_idx[k]);
        rear[k] = r.fetch(r_idx[k]);
      }
      drive(v, st, front, rear, r, i, V, g, p);
    }

    stage_post(c, i, live, v);
    __syncthreads();

    // --- collisions: sphere pre-check, swept SAT, last-write impacts -------
    if (live) {
      bool any_inter = false;
      int row_j = -1, col_j = -1;
      float row_tx = 0.f, row_ty = 0.f, col_tx = 0.f, col_ty = 0.f;
      for (int j = 0; j < V; ++j) {
        if (j == i) continue;
        const int a = min(i, j), b = max(i, j);  // a = the pair's ``self``
        if (!pair_eligible(c.flags[a], c.flags[b])) continue;
        const float dx = c.px[a] - c.px[b], dy = c.py[a] - c.py[b];
        const float reach = (c.diag[a] + c.diag[b]) / 2.f + c.speed[a] * p.dt;
        if (!(dx * dx + dy * dy <= reach * reach)) continue;
        bool inter, will;
        float tx, ty;
        sat(c.px[a], c.py[a], c.len[a], c.wid[a], c.cos[a], c.sin[a], c.px[b],
            c.py[b], c.len[b], c.wid[b], c.cos[b], c.sin[b],
            (c.vx[a] - c.vx[b]) * p.dt, (c.vy[a] - c.vy[b]) * p.dt, &inter,
            &will, &tx, &ty);
        any_inter = any_inter || inter;
        if (will) {
          // ascending j: the last write is the max-index partner
          if (j > i) {
            row_j = j;
            row_tx = 0.5f * tx;
            row_ty = 0.5f * ty;
          } else {
            col_j = j;
            col_tx = -0.5f * tx;
            col_ty = -0.5f * ty;
          }
        }
      }
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

  if (live) v.store(f, o);
}

extern "C" int straight_frames(
    const float* pos, const float* heading, const float* speed, const int* lane,
    const int* target_lane, const float* target_speed, const float* timer,
    const uint8_t* crashed, const uint8_t* impact_pending, const float* impact,
    const float* steering, const float* accel, const float* delta,
    const int* kind, const float* length, const float* width,
    const uint8_t* check_collisions, const uint8_t* collidable,
    const uint8_t* enable_lane_change, const float* mobil_gain,
    const float* mobil_max_braking, float* pos_out, float* heading_out,
    float* speed_out, int* lane_out, int* target_lane_out, float* timer_out,
    uint8_t* crashed_out, uint8_t* impact_pending_out, float* impact_out,
    float* steering_out, float* accel_out, const uint8_t* mask,
    const Geo* geo, const Params* params, int B, int V, int frames,
    void* stream) {
  Fields f = {pos,          heading,          speed,           lane,
              target_lane,  target_speed,     timer,           crashed,
              impact_pending, impact,         steering,        accel,
              delta,        kind,             length,          width,
              check_collisions, collidable,   enable_lane_change, mobil_gain,
              mobil_max_braking, pos_out,     heading_out,     speed_out,
              lane_out,     target_lane_out,  timer_out,       crashed_out,
              impact_pending_out, impact_out, steering_out,    accel_out};
  return launch_per_env(straight_frames_kernel, B, V, START_ARRAYS + POST_ARRAYS,
                        stream, f, mask, *geo, *params, V, frames);
}
