// All frames of one policy step on a straight multi-lane road, one thread
// block per env and one thread per vehicle slot.
//
// Replaces the TPU kernel highwayenv_tpu/ops/straight_pallas_bm.py::
// build_pallas_frame(sorted_mode=False) (pallas_call at :1190, frame body
// _frame_body :545-1117): the dense frame megakernel.  Semantics are those of
// ops/straight_frames.py::frames_plain, its plain torch version, in the
// specialization the straight highway envs spawn: vehicles only (no
// obstacles or landmarks) and IDM NPCs (no Linear-family presets).
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
//
// Rounding: built with -fmad=false and the precise libm functions, so every
// operation rounds as the op-by-op torch version does on the same card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_LANES 16
#define KIND_PAD 0
#define KIND_EGO 1
#define KIND_IDM 2
#define KIND_LINEAR 3
#define KIND_PLAIN 4
#define KIND_LANDMARK 6
#define VEHICLE_LENGTH 5.0f
#define MAX_SPEED 40.0f
#define MIN_SPEED (-40.0f)
#define PI_F 3.14159265358979323846f
#define TWO_PI_F 6.28318530717958647692f
#define QUARTER_PI_F 0.78539816339744830962f
#define MAX_STEER_F 1.04719755119659774615f
#define NOT_ZERO_EPS 0.01f

// shared-memory arrays per env, each blockDim.x words
#define SMEM_ARRAYS 23

// flag bits
#define F_OCCUPIABLE 1
#define F_VEHICLE 2
#define F_CONTROLLED 4
#define F_ACTIVE 1
#define F_CHECK 4
#define F_COLLIDABLE 8

struct Geo {  // ops/straight_frames.py::_Geo
  float ox, oy, ux, uy, nx, ny;
  float theta;        // lane heading
  float in_range_hi;  // road length + VEHICLE_LENGTH
  float member_tol;   // lane membership: |lat - off| <= width / 2 + 1
  float reach_lat;    // MOBIL reachability: |lat - off| <= 2 width
  float speed_limit;
  int has_limit;
  int n_lanes;
  float offsets[MAX_LANES];
};

struct Params {  // ops/straight_frames.py::_Params
  float dt;
  float acc_max, comfort_acc_max, distance_wanted, time_wanted;
  float inv_two_sqrt_ab, politeness, lane_change_delay;
  float kp_a, kp_heading, kp_lateral;
};

struct Fields {
  const float* pos;
  const float* heading;
  const float* speed;
  const int* lane;
  const int* target_lane;
  const float* target_speed;
  const float* timer;
  const uint8_t* crashed;
  const uint8_t* impact_pending;
  const float* impact;
  const float* steering;
  const float* accel;
  const float* delta;
  const int* kind;
  const float* length;
  const float* width;
  const uint8_t* check_collisions;
  const uint8_t* collidable;
  const uint8_t* enable_lane_change;
  const float* mobil_gain;
  const float* mobil_max_braking;
  float* pos_out;
  float* heading_out;
  float* speed_out;
  int* lane_out;
  int* target_lane_out;
  float* timer_out;
  uint8_t* crashed_out;
  uint8_t* impact_pending_out;
  float* impact_out;
  float* steering_out;
  float* accel_out;
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

__device__ __forceinline__ float not_zero(float x) {
  return fabsf(x) > NOT_ZERO_EPS ? x : (x >= 0.f ? NOT_ZERO_EPS : -NOT_ZERO_EPS);
}

// ((x + pi) mod 2 pi) - pi with a floored mod, as torch.remainder computes it
__device__ __forceinline__ float wrap_to_pi(float x) {
  float m = fmodf(x + PI_F, TWO_PI_F);
  if (m != 0.f && (m < 0.f)) m += TWO_PI_F;
  return m - PI_F;
}

// A neighbour row; ex = false is the all-zero row of a missing neighbour.
struct Row {
  float speed, target_speed, s, vx, vy, c, sn;
  bool ex, vehicle;
};

// vehicle/behavior.py::idm_acceleration masked as _frame_plain's accel()
__device__ __forceinline__ float accel_pair(const Params& p, const Geo& g,
                                            float delta, const Row& e,
                                            const Row& f) {
  if (!(e.ex && e.vehicle)) return 0.f;
  float ts = g.has_limit ? clampf(e.target_speed, 0.f, g.speed_limit)
                         : e.target_speed;
  float free_acc = p.comfort_acc_max *
                   (1.0f - powf(fmaxf(e.speed, 0.f) / fabsf(not_zero(ts)), delta));
  float d = f.s - e.s;
  float dv = (e.speed * e.c - f.vx) * e.c + (e.speed * e.sn - f.vy) * e.sn;
  float d_star = (p.distance_wanted + e.speed * p.time_wanted) +
                 (e.speed * dv) * p.inv_two_sqrt_ab;
  float q = d_star / not_zero(d);
  float interaction = p.comfort_acc_max * (q * q);
  return free_acc - (f.ex ? interaction : 0.f);
}

// utils/math.py::rects_intersecting_xy_folded for rectangle a (the lower
// slot) against b, with a's displacement relative to b over the frame.
__device__ void sat(float dax, float day, float la, float wa, float ca,
                    float sa, float dbx, float dby, float lb, float wb,
                    float cb, float sb, float relx, float rely, bool* inter,
                    bool* will, float* tx, float* ty) {
  float norm_a = ca * ca + sa * sa;
  float norm_b = cb * cb + sb * sb;
  float adcc = fabsf(ca * cb + sa * sb);
  float adcs = fabsf(ca * sb - sa * cb);
  float ha_l = la / 2.f, ha_w = wa / 2.f;
  float hb_l = lb / 2.f, hb_w = wb / 2.f;
  float cp_a[4], cp_b[4], vp[4], ext_a[4], ext_b[4];
  cp_a[0] = -(ca * dax + sa * day);
  cp_b[0] = -(ca * dbx + sa * dby);
  vp[0] = -(ca * relx + sa * rely);
  ext_a[0] = ha_l * norm_a;
  ext_b[0] = hb_l * adcc + hb_w * adcs;
  cp_a[1] = ca * day - sa * dax;
  cp_b[1] = ca * dby - sa * dbx;
  vp[1] = ca * rely - sa * relx;
  ext_a[1] = ha_w * norm_a;
  ext_b[1] = hb_l * adcs + hb_w * adcc;
  cp_a[2] = -(cb * dax + sb * day);
  cp_b[2] = -(cb * dbx + sb * dby);
  vp[2] = -(cb * relx + sb * rely);
  ext_a[2] = ha_l * adcc + ha_w * adcs;
  ext_b[2] = hb_l * norm_b;
  cp_a[3] = cb * day - sb * dax;
  cp_b[3] = cb * dby - sb * dbx;
  vp[3] = cb * rely - sb * relx;
  ext_a[3] = ha_l * adcs + ha_w * adcc;
  ext_b[3] = hb_w * norm_b;

  bool now_all = true, swept_all = true;
  float neg_d[4], pos_d[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float min_a = cp_a[k] - ext_a[k], max_a = cp_a[k] + ext_a[k];
    float min_b = cp_b[k] - ext_b[k], max_b = cp_b[k] + ext_b[k];
    now_all = now_all && (min_b - max_a <= 0.f) && (min_a - max_b <= 0.f);
    float as_lo = min_a + fminf(vp[k], 0.f);
    float as_hi = max_a + fmaxf(vp[k], 0.f);
    float v1 = min_b - as_hi;
    float v2 = as_lo - max_b;
    swept_all = swept_all && (v1 <= 0.f) && (v2 <= 0.f);
    neg_d[k] = as_lo < min_b ? v1 : v2;
    pos_d[k] = max_b < as_hi ? v2 : v1;
  }
  // the 8 signed candidates in the reference's winding order; strict <
  // keeps the first minimum
  const float cand_d[8] = {neg_d[0], neg_d[1], pos_d[0], pos_d[1],
                           neg_d[2], neg_d[3], pos_d[2], pos_d[3]};
  const float cand_x[8] = {-ca, -sa, ca, sa, -cb, -sb, cb, sb};
  const float cand_y[8] = {-sa, ca, sa, -ca, -sb, cb, sb, -cb};
  float md = fabsf(cand_d[0]), bx = cand_x[0], by = cand_y[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    float ad = fabsf(cand_d[k]);
    if (ad < md) {
      md = ad;
      bx = cand_x[k];
      by = cand_y[k];
    }
  }
  float dcx = dax - dbx, dcy = day - dby;
  float sign = (dcx * bx + dcy * by > 0.f) ? 1.f : -1.f;
  *inter = now_all;
  *will = swept_all;
  *tx = (md * sign) * bx;
  *ty = (md * sign) * by;
}

__global__ void straight_frames_kernel(Fields f, Geo g, Params p, int V,
                                       int frames) {
  extern __shared__ float smem[];
  const int N = blockDim.x;
  // frame-start rows, read by the neighbour and abort scans
  float* r_s = smem;
  float* r_lat = r_s + N;
  float* r_speed = r_lat + N;
  float* r_ts = r_speed + N;
  float* r_vx = r_ts + N;
  float* r_vy = r_vx + N;
  float* r_cos = r_vy + N;
  float* r_sin = r_cos + N;
  int* r_lane = reinterpret_cast<int*>(r_sin + N);
  int* r_tlane = r_lane + N;
  int* r_flags = r_tlane + N;
  // post-integration rows, read by the collision pass
  float* c_px = reinterpret_cast<float*>(r_flags + N);
  float* c_py = c_px + N;
  float* c_speed = c_py + N;
  float* c_cos = c_speed + N;
  float* c_sin = c_cos + N;
  float* c_vx = c_sin + N;
  float* c_vy = c_vx + N;
  float* c_len = c_vy + N;
  float* c_wid = c_len + N;
  float* c_diag = c_wid + N;
  int* c_flags = reinterpret_cast<int*>(c_diag + N);
  // c_flags + N ends the SMEM_ARRAYS = 23 arrays

  const int i = threadIdx.x;
  const bool live = i < V;
  const size_t o = static_cast<size_t>(blockIdx.x) * V + i;
  const int L = g.n_lanes;

  float px = 0.f, py = 0.f, heading = 0.f, speed = 0.f, ts = 0.f, timer = 0.f;
  float ix = 0.f, iy = 0.f, steer = 0.f, acc = 0.f, delta = 4.f;
  float len = 5.f, wid = 2.f, gain = 0.f, max_braking = 0.f;
  int lane = 0, tlane = 0, kind = KIND_PAD;
  bool crashed = false, pend = false, chk = false, coll = false, elc = false;
  if (live) {
    px = f.pos[2 * o];
    py = f.pos[2 * o + 1];
    heading = f.heading[o];
    speed = f.speed[o];
    lane = f.lane[o];
    tlane = f.target_lane[o];
    ts = f.target_speed[o];
    timer = f.timer[o];
    crashed = f.crashed[o] != 0;
    pend = f.impact_pending[o] != 0;
    ix = f.impact[2 * o];
    iy = f.impact[2 * o + 1];
    steer = f.steering[o];
    acc = f.accel[o];
    delta = f.delta[o];
    kind = f.kind[o];
    len = f.length[o];
    wid = f.width[o];
    chk = f.check_collisions[o] != 0;
    coll = f.collidable[o] != 0;
    elc = f.enable_lane_change[o] != 0;
    gain = f.mobil_gain[o];
    max_braking = f.mobil_max_braking[o];
  }
  const bool active = kind != KIND_PAD;
  const bool is_veh = kind >= KIND_EGO && kind <= KIND_PLAIN;
  const bool is_ctrl = kind >= KIND_EGO && kind <= KIND_LINEAR;
  const bool is_ego = kind == KIND_EGO;
  c_len[i] = len;
  c_wid[i] = wid;
  c_diag[i] = sqrtf(len * len + wid * wid);

  for (int frame = 0; frame < frames; ++frame) {
    // --- frame-start rows ------------------------------------------------
    const float s = (px - g.ox) * g.ux + (py - g.oy) * g.uy;
    const float lat0 = (px - g.ox) * g.nx + (py - g.oy) * g.ny;
    const float ch = cosf(heading), sh = sinf(heading);
    const float vx = speed * ch, vy = speed * sh;
    const bool occ = (-VEHICLE_LENGTH <= s) && (s < g.in_range_hi) && active &&
                     kind != KIND_LANDMARK;
    r_s[i] = s;
    r_lat[i] = lat0;
    r_speed[i] = speed;
    r_ts[i] = ts;
    r_vx[i] = vx;
    r_vy[i] = vy;
    r_cos[i] = ch;
    r_sin[i] = sh;
    r_lane[i] = lane;
    r_tlane[i] = tlane;
    r_flags[i] = live ? ((occ ? F_OCCUPIABLE : 0) | (is_veh ? F_VEHICLE : 0) |
                         (is_ctrl ? F_CONTROLLED : 0))
                      : 0;
    __syncthreads();

    if (live) {
      // --- neighbours on the own lane and lanes -1 / +1 -------------------
      const bool idm = kind == KIND_IDM && !crashed;
      int q_lane[3] = {lane, clampi(lane - 1, 0, L - 1), clampi(lane + 1, 0, L - 1)};
      float q_off[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) q_off[k] = g.offsets[clampi(q_lane[k], 0, L - 1)];
      float f_key[3] = {INFINITY, INFINITY, INFINITY};
      float r_key[3] = {-INFINITY, -INFINITY, -INFINITY};
      int f_idx[3] = {-1, -1, -1};
      int r_idx[3] = {-1, -1, -1};
      for (int c = 0; c < V; ++c) {
        if (c == i || !(r_flags[c] & F_OCCUPIABLE)) continue;
        const float sc = r_s[c], lc = r_lat[c];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          if (fabsf(lc - q_off[k]) <= g.member_tol) {
            // front: smallest s_c >= s, the last column among ties
            if (s <= sc && sc <= f_key[k]) {
              f_key[k] = sc;
              f_idx[k] = c;
            }
            // rear: largest s_c < s, the first column among ties
            if (sc < s && sc > r_key[k]) {
              r_key[k] = sc;
              r_idx[k] = c;
            }
          }
        }
      }
      Row front[3], rear[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        Row* rows[2] = {&front[k], &rear[k]};
        const int idx[2] = {f_idx[k], r_idx[k]};
        for (int m = 0; m < 2; ++m) {
          const int j = idx[m];
          Row& r = *rows[m];
          r.ex = j >= 0;
          if (r.ex) {
            r.speed = r_speed[j];
            r.target_speed = r_ts[j];
            r.s = r_s[j];
            r.vx = r_vx[j];
            r.vy = r_vy[j];
            r.c = r_cos[j];
            r.sn = r_sin[j];
            r.vehicle = (r_flags[j] & F_VEHICLE) != 0;
          } else {
            r.speed = r.target_speed = r.s = r.vx = r.vy = r.c = r.sn = 0.f;
            r.vehicle = false;
          }
        }
      }
      const Row self = {speed, ts, s, vx, vy, ch, sh, true, is_veh};

      // --- MOBIL lane change ----------------------------------------------
      const float a_self = accel_pair(p, g, delta, self, front[0]);
      const bool mid_change = lane != tlane;
      const bool deciding = idm && !mid_change && timer > p.lane_change_delay && elc;
      float new_timer = deciding ? 0.f : timer;
      int target = tlane;
      if (deciding) {
        const float a_of = accel_pair(p, g, delta, rear[0], self);
        const float a_of_pred = accel_pair(p, g, delta, rear[0], front[0]);
        const bool moving = fabsf(speed) >= 1.0f;
#pragma unroll
        for (int k = 1; k < 3; ++k) {
          const int d = k == 1 ? -1 : 1;
          const bool exists = lane + d >= 0 && lane + d < L;
          const float a_nf = accel_pair(p, g, delta, rear[k], front[k]);
          const float a_nf_pred = accel_pair(p, g, delta, rear[k], self);
          const float a_self_pred = accel_pair(p, g, delta, self, front[k]);
          const bool safe = a_nf_pred >= -max_braking;
          const float jerk = (a_self_pred - a_self) +
                             p.politeness * (((a_nf_pred - a_nf) + a_of_pred) - a_of);
          const bool reachable = fabsf(lat0 - q_off[k]) <= g.reach_lat &&
                                 0.f <= s && s < g.in_range_hi;
          if (exists && reachable && moving && safe && jerk >= gain) target = q_lane[k];
        }
      }
      // abort a lane change into a gap another vehicle is closing
      if (idm && mid_change) {
        bool conflict = false;
        for (int j = 0; j < V && !conflict; ++j) {
          if (j == i || !(r_flags[j] & F_CONTROLLED)) continue;
          if (r_lane[j] == tlane || r_tlane[j] != tlane) continue;
          const float d_ij = r_s[j] - s;
          const float dv = (vx - r_vx[j]) * ch + (vy - r_vy[j]) * sh;
          const float d_star = (p.distance_wanted + speed * p.time_wanted) +
                               (speed * dv) * p.inv_two_sqrt_ab;
          conflict = 0.f < d_ij && d_ij < d_star;
        }
        if (conflict) target = lane;
      }

      // --- low-level controls ---------------------------------------------
      const float lat_t = lat0 - g.offsets[clampi(target, 0, L - 1)];
      const float heading_cmd =
          asinf(clampf((-p.kp_lateral * lat_t) / not_zero(speed), -1.f, 1.f));
      const float heading_ref = g.theta + clampf(heading_cmd, -QUARTER_PI_F, QUARTER_PI_F);
      const float rate = p.kp_heading * wrap_to_pi(heading_ref - heading);
      const float slip = asinf(clampf(len / 2.f / not_zero(speed) * rate, -1.f, 1.f));
      const float steer_pc =
          clampf(atan2f(2.f * sinf(slip), cosf(slip)), -MAX_STEER_F, MAX_STEER_F);
      // dual-lane IDM while changing lanes
      const int d_t = target - lane;
      const Row& f_t = d_t == 0 ? front[0] : (d_t < 0 ? front[1] : front[2]);
      const float a_t = accel_pair(p, g, delta, self, f_t);
      const float a_idm =
          clampf(target != lane ? fminf(a_self, a_t) : a_self, -p.acc_max, p.acc_max);
      if (is_ego || idm) steer = steer_pc;
      if (is_ego) {
        acc = p.kp_a * (ts - speed);
      } else if (idm) {
        acc = a_idm;
      }
      tlane = target;

      // --- bicycle integration and re-localization ------------------------
      if (is_veh) {
        const float st = crashed ? 0.f : steer;
        float ac = crashed ? -1.0f * speed : acc;
        ac = speed > MAX_SPEED ? fminf(ac, MAX_SPEED - speed)
                               : (speed < MIN_SPEED ? fmaxf(ac, MIN_SPEED - speed) : ac);
        const float beta = atanf(0.5f * tanf(st));
        const float hb = heading + beta;
        px = (px + (speed * cosf(hb)) * p.dt) + (pend ? ix : 0.f);
        py = (py + (speed * sinf(hb)) * p.dt) + (pend ? iy : 0.f);
        crashed = crashed || pend;
        heading = heading + speed * sinf(beta) / (len / 2.f) * p.dt;
        speed = speed + ac * p.dt;
        ix = 0.f;
        iy = 0.f;
        pend = false;
        new_timer = new_timer + p.dt;
        const float lat_new = (px - g.ox) * g.nx + (py - g.oy) * g.ny;
        int best = 0;
        float best_d = fabsf(lat_new - g.offsets[0]);
        for (int l = 1; l < L; ++l) {
          const float dl = fabsf(lat_new - g.offsets[l]);
          if (dl < best_d) {
            best_d = dl;
            best = l;
          }
        }
        lane = best;
      }
      timer = new_timer;
    }

    // --- post-integration rows -------------------------------------------
    c_px[i] = px;
    c_py[i] = py;
    c_speed[i] = speed;
    const float c2 = cosf(heading), s2 = sinf(heading);
    c_cos[i] = c2;
    c_sin[i] = s2;
    c_vx[i] = speed * c2;
    c_vy[i] = speed * s2;
    c_flags[i] = live ? ((active ? F_ACTIVE : 0) | (is_veh ? F_VEHICLE : 0) |
                         (chk ? F_CHECK : 0) | (coll ? F_COLLIDABLE : 0))
                      : 0;
    __syncthreads();

    // --- collisions: sphere pre-check, swept SAT, last-write impacts -------
    if (live) {
      bool any_inter = false;
      int row_j = -1, col_j = -1;
      float row_tx = 0.f, row_ty = 0.f, col_tx = 0.f, col_ty = 0.f;
      for (int j = 0; j < V; ++j) {
        if (j == i) continue;
        const int a = min(i, j), b = max(i, j);  // a = the pair's ``self``
        const int fa = c_flags[a], fb = c_flags[b];
        if (!((fa & F_ACTIVE) && (fb & F_ACTIVE))) continue;
        if (!((fa & F_VEHICLE) || (fb & F_VEHICLE))) continue;
        if (!((fa & F_CHECK) || (fb & F_CHECK))) continue;
        if (!((fa & F_COLLIDABLE) && (fb & F_COLLIDABLE))) continue;
        const float dx = c_px[a] - c_px[b], dy = c_py[a] - c_py[b];
        const float reach = (c_diag[a] + c_diag[b]) / 2.f + c_speed[a] * p.dt;
        if (!(dx * dx + dy * dy <= reach * reach)) continue;
        bool inter, will;
        float tx, ty;
        sat(c_px[a], c_py[a], c_len[a], c_wid[a], c_cos[a], c_sin[a], c_px[b],
            c_py[b], c_len[b], c_wid[b], c_cos[b], c_sin[b],
            (c_vx[a] - c_vx[b]) * p.dt, (c_vy[a] - c_vy[b]) * p.dt, &inter,
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
        ix = row_tx;
        iy = row_ty;
      } else if (col_j >= 0) {
        ix = col_tx;
        iy = col_ty;
      }
      pend = pend || row_j >= 0 || col_j >= 0;
      crashed = crashed || any_inter;
    }
  }

  if (live) {
    f.pos_out[2 * o] = px;
    f.pos_out[2 * o + 1] = py;
    f.heading_out[o] = heading;
    f.speed_out[o] = speed;
    f.lane_out[o] = lane;
    f.target_lane_out[o] = tlane;
    f.timer_out[o] = timer;
    f.crashed_out[o] = crashed ? 1 : 0;
    f.impact_pending_out[o] = pend ? 1 : 0;
    f.impact_out[2 * o] = ix;
    f.impact_out[2 * o + 1] = iy;
    f.steering_out[o] = steer;
    f.accel_out[o] = acc;
  }
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
    float* steering_out, float* accel_out, const Geo* geo,
    const Params* params, int B, int V, int frames, void* stream) {
  Fields f = {pos,          heading,          speed,           lane,
              target_lane,  target_speed,     timer,           crashed,
              impact_pending, impact,         steering,        accel,
              delta,        kind,             length,          width,
              check_collisions, collidable,   enable_lane_change, mobil_gain,
              mobil_max_braking, pos_out,     heading_out,     speed_out,
              lane_out,     target_lane_out,  timer_out,       crashed_out,
              impact_pending_out, impact_out, steering_out,    accel_out};
  const int threads = ((V + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(SMEM_ARRAYS) * threads * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        straight_frames_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (B > 0 && V > 0) {
    straight_frames_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        f, *geo, *params, V, frames);
  }
  return static_cast<int>(cudaGetLastError());
}
