// All frames of one policy step on a straight multi-lane road, on the
// s-sorted layout: one thread block per env and one thread per rank.
//
// Replaces the TPU kernel highwayenv_tpu/ops/straight_pallas_bm.py::
// build_pallas_frame(sorted_mode=True) (pallas_call at :1190): _frame_body
// with the banded neighbour pass _neigh_banded (:317-542) and the banded
// collision pass _collisions_sorted_lean (:129-302).  Semantics are those of
// ops/straight_sorted.py::frames_sorted_plain, its plain torch version.  The
// slot rows arrive in the rank order of ops/straight_sorted.py::sort_kernel
// (ascending s at the start of the policy step), with idx giving each rank's
// original slot.  Everything but the two pair searches is the dense
// kernel's code, in straight_common.cuh.
//
//   neighbours: ranks r-Wn..r+Wn in ascending rank with the dense
//     predicates (front `<=`: the larger rank wins ties; rear strict `>`:
//     the smaller rank wins), plus, per lane, the winner beyond the band: a
//     suffix argmin of s over ranks > r+Wn (ties to the larger rank) and a
//     prefix argmax over ranks < r-Wn (ties to the smaller rank), each a
//     Hillis-Steele scan in shared memory.  A far member that crossed the
//     query in s since the sort raises the neighbour flag, on rows that
//     consume the result (the own lane for uncrashed IDM rows, lanes -1 / +1
//     for deciding or mid-change rows).
//   collisions: the swept SAT on the pairs at rank distance 1..W behind the
//     dense pass's sphere gate, the lower rank as the SAT's first rectangle,
//     reach with the speed of the lower original slot, and the last-write
//     impact as a max over the partner's original slot, the row side
//     (this slot is the pair's `self`, the lower original slot) beating the
//     column side.  The collision flag rises where an active rank beyond
//     r+W could be within R = max diag + max speed * dt of the rank's s
//     (suffix min / max scans of s; R over this env's active slots).
//
// Each flag is sticky over the frames and written once per env (flags[2b]
// collision, flags[2b+1] neighbour); the caller re-runs a flagged env
// through the dense kernel, so the accepted result is always exact.
//
// What bounds it on an H100: float32 operations, as the dense kernel, but
// O(V (W + Wn + L log V)) pair work a frame in place of O(V^2) for the two
// searches; the abort pass stays dense.  What the design does about it: as
// the dense kernel (fields in shared memory across frames, one pass over
// device memory, both members of a pair evaluate it, no atomics); the scans
// carry only the winner's rank, its s and row are read from the staged rows.

#include "straight_common.cuh"

__global__ void straight_frames_sorted_kernel(Fields f, const int* idx,
                                              uint8_t* flags, Geo g, Params p,
                                              int V, int frames, int W, int Wn) {
  extern __shared__ float smem[];
  const int N = blockDim.x;
  const int L = g.n_lanes;
  StartRows r;
  PostRows c;
  int* orig = reinterpret_cast<int*>(c.carve(r.carve(smem, N), N));
  // winner ranks of the far-band scans, [2 buffers][ahead, behind][L][N]
  int* nwin = orig + N;
  // collision-band scans, [2 buffers][s min, s max, diag max, speed max][N]
  float* cscan = reinterpret_cast<float*>(nwin + 4 * L * N);
#define NWIN(b, dir, l, j) nwin[(((b) * 2 + (dir)) * L + (l)) * N + (j)]
#define CSCAN(b, m, j) cscan[((b) * 4 + (m)) * N + (j)]

  const int i = threadIdx.x;
  const bool live = i < V;
  const size_t o = static_cast<size_t>(blockIdx.x) * V + i;
  Slot v;
  if (live) v.load(f, o);
  c.len[i] = v.len;
  c.wid[i] = v.wid;
  c.diag[i] = sqrtf(v.len * v.len + v.wid * v.wid);
  orig[i] = live ? idx[o] : -1;
  bool viol_coll = false, viol_neigh = false;

  for (int frame = 0; frame < frames; ++frame) {
    const Start st = frame_start(v, g);
    stage_start(r, i, live, v, st);
    for (int l = 0; l < L; ++l) {
      const bool member =
          live && st.occ && fabsf(st.lat0 - g.offsets[l]) <= g.member_tol;
      NWIN(0, 0, l, i) = member ? i : -1;
      NWIN(0, 1, l, i) = member ? i : -1;
    }
    __syncthreads();

    // --- far-band winners per lane: inclusive suffix argmin / prefix argmax
    int cur = 0;
    for (int k = 1; k < V; k *= 2) {
      if (live) {
        for (int l = 0; l < L; ++l) {
          int w = NWIN(cur, 0, l, i);
          if (i + k < V) {
            const int w2 = NWIN(cur, 0, l, i + k);
            if (w2 >= 0 && (w < 0 || r.s[w2] <= r.s[w])) w = w2;
          }
          NWIN(1 - cur, 0, l, i) = w;
          w = NWIN(cur, 1, l, i);
          if (i - k >= 0) {
            const int w2 = NWIN(cur, 1, l, i - k);
            if (w2 >= 0 && (w < 0 || r.s[w2] >= r.s[w])) w = w2;
          }
          NWIN(1 - cur, 1, l, i) = w;
        }
      }
      cur = 1 - cur;
      __syncthreads();
    }

    if (live) {
      // --- banded neighbours on the own lane and lanes -1 / +1 -------------
      const bool idm = is_idm(v);
      const bool mid_change = v.lane != v.tlane;
      const bool deciding = idm && !mid_change && v.timer > p.lane_change_delay && v.elc;
      Row front[3], rear[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int ql = clampi(st.q_lane[k], 0, L - 1);
        const int a = i + Wn + 1 < V ? NWIN(cur, 0, ql, i + Wn + 1) : -1;
        const int b = i - Wn - 1 >= 0 ? NWIN(cur, 1, ql, i - Wn - 1) : -1;
        const bool crossed = (a >= 0 && r.s[a] < st.s) || (b >= 0 && r.s[b] >= st.s);
        if (crossed && (k == 0 ? idm : (deciding || mid_change))) viol_neigh = true;
        float f_key = INFINITY, r_key = -INFINITY;
        int f_idx = -1, r_idx = -1;
        if (b >= 0 && r.s[b] < st.s) {  // far behind first: it has the smallest ranks
          r_key = r.s[b];
          r_idx = b;
        }
        for (int dd = -Wn; dd <= Wn; ++dd) {
          const int col = i + dd;
          if (dd == 0 || col < 0 || col >= V || !(r.flags[col] & F_OCCUPIABLE)) continue;
          if (!(fabsf(r.lat[col] - st.q_off[k]) <= g.member_tol)) continue;
          const float sc = r.s[col];
          if (st.s <= sc && sc <= f_key) {
            f_key = sc;
            f_idx = col;
          }
          if (sc < st.s && sc > r_key) {
            r_key = sc;
            r_idx = col;
          }
        }
        if (a >= 0 && st.s <= r.s[a] && r.s[a] <= f_key) f_idx = a;  // far ahead last
        front[k] = r.fetch(f_idx);
        rear[k] = r.fetch(r_idx);
      }
      drive(v, st, front, rear, r, i, V, g, p);
    }

    stage_post(c, i, live, v);
    const bool act = live && v.active();
    const float s_new = (v.px - g.ox) * g.ux + (v.py - g.oy) * g.uy;
    CSCAN(0, 0, i) = act ? s_new : INFINITY;
    CSCAN(0, 1, i) = act ? s_new : -INFINITY;
    CSCAN(0, 2, i) = act ? c.diag[i] : 0.f;
    CSCAN(0, 3, i) = act ? v.speed : 0.f;
    __syncthreads();

    // --- suffix min / max of s, and the env's max diag and speed -----------
    cur = 0;
    for (int k = 1; k < V; k *= 2) {
      if (live) {
        float m0 = CSCAN(cur, 0, i), m1 = CSCAN(cur, 1, i);
        float m2 = CSCAN(cur, 2, i), m3 = CSCAN(cur, 3, i);
        if (i + k < V) {
          m0 = fminf(m0, CSCAN(cur, 0, i + k));
          m1 = fmaxf(m1, CSCAN(cur, 1, i + k));
          m2 = fmaxf(m2, CSCAN(cur, 2, i + k));
          m3 = fmaxf(m3, CSCAN(cur, 3, i + k));
        }
        CSCAN(1 - cur, 0, i) = m0;
        CSCAN(1 - cur, 1, i) = m1;
        CSCAN(1 - cur, 2, i) = m2;
        CSCAN(1 - cur, 3, i) = m3;
      }
      cur = 1 - cur;
      __syncthreads();
    }

    // --- banded collisions: sphere pre-check, swept SAT, last-write impacts
    if (live) {
      const float R = CSCAN(cur, 2, 0) + CSCAN(cur, 3, 0) * p.dt;
      const int far = i + W + 1;
      if (act && far < V && CSCAN(cur, 0, far) <= s_new + R &&
          CSCAN(cur, 1, far) >= s_new - R) {
        viol_coll = true;
      }
      const int me = orig[i];
      bool any_inter = false, any_will = false;
      int best_r = -1, best_c = -1;  // the partner's original slot
      float imp_rx = 0.f, imp_ry = 0.f, imp_cx = 0.f, imp_cy = 0.f;
      for (int d = -W; d <= W; ++d) {
        const int j = i + d;
        if (d == 0 || j < 0 || j >= V) continue;
        const int a = min(i, j), b = max(i, j);  // a = the lower rank
        if (!pair_eligible(c.flags[a], c.flags[b])) continue;
        const float dx = c.px[a] - c.px[b], dy = c.py[a] - c.py[b];
        const float speed_lo = orig[a] < orig[b] ? c.speed[a] : c.speed[b];
        const float reach = (c.diag[a] + c.diag[b]) / 2.f + speed_lo * p.dt;
        if (!(dx * dx + dy * dy <= reach * reach)) continue;
        bool inter, will;
        float tx, ty;
        sat(c.px[a], c.py[a], c.len[a], c.wid[a], c.cos[a], c.sin[a], c.px[b],
            c.py[b], c.len[b], c.wid[b], c.cos[b], c.sin[b],
            (c.vx[a] - c.vx[b]) * p.dt, (c.vy[a] - c.vy[b]) * p.dt, &inter,
            &will, &tx, &ty);
        any_inter = any_inter || inter;
        if (will) {
          any_will = true;
          // half the translation toward this slot: +t for the lower rank
          const float hx = 0.5f * tx, hy = 0.5f * ty;
          const float to_x = i == a ? hx : -hx, to_y = i == a ? hy : -hy;
          const int partner = orig[j];
          if (me < partner) {
            if (partner > best_r) {
              best_r = partner;
              imp_rx = to_x;
              imp_ry = to_y;
            }
          } else if (partner > best_c) {
            best_c = partner;
            imp_cx = to_x;
            imp_cy = to_y;
          }
        }
      }
      if (best_r >= 0) {
        v.ix = imp_rx;
        v.iy = imp_ry;
      } else if (best_c >= 0) {
        v.ix = imp_cx;
        v.iy = imp_cy;
      }
      v.pend = v.pend || any_will;
      v.crashed = v.crashed || any_inter;
    }
  }
#undef NWIN
#undef CSCAN

  const int any_coll = __syncthreads_or(viol_coll);
  const int any_neigh = __syncthreads_or(viol_neigh);
  if (live) v.store(f, o);
  if (i == 0) {
    flags[2 * blockIdx.x] = any_coll ? 1 : 0;
    flags[2 * blockIdx.x + 1] = any_neigh ? 1 : 0;
  }
}

extern "C" int straight_frames_sorted(
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
    float* steering_out, float* accel_out, const int* idx, uint8_t* flags,
    const Geo* geo, const Params* params, int B, int V, int frames, int W,
    int Wn, void* stream) {
  Fields f = {pos,          heading,          speed,           lane,
              target_lane,  target_speed,     timer,           crashed,
              impact_pending, impact,         steering,        accel,
              delta,        kind,             length,          width,
              check_collisions, collidable,   enable_lane_change, mobil_gain,
              mobil_max_braking, pos_out,     heading_out,     speed_out,
              lane_out,     target_lane_out,  timer_out,       crashed_out,
              impact_pending_out, impact_out, steering_out,    accel_out};
  // rows, original slots, the far-band scans and the collision-band scans
  const int words = START_ARRAYS + POST_ARRAYS + 1 + 4 * geo->n_lanes + 8;
  return launch_per_env(straight_frames_sorted_kernel, B, V, words, stream, f,
                        idx, flags, *geo, *params, V, frames, W, Wn);
}
