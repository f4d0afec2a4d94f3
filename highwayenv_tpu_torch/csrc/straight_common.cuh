// Device code shared by the dense (straight_frames.cu) and the s-sorted
// banded (straight_frames_sorted.cu) frame kernels: the constants, the
// geometry and IDM parameters, the field pointers, one slot's registers,
// the rows staged in shared memory, the IDM acceleration of a row pair, the
// folded swept SAT, and one slot's MOBIL decision, controls, bicycle
// integration and re-localization.  The two kernels differ only in how they
// find neighbours and collision partners, so everything a frame does around
// those two searches lives here and the kernels cannot drift apart.
//
// Semantics are those of ops/straight_frames.py (frames_plain and its
// phases), in the specialization the straight highway envs spawn: vehicles
// only (no obstacles or landmarks) and IDM NPCs (no Linear-family presets).
// Rounding: the kernels are built with -fmad=false and the precise libm
// functions, so every operation rounds as the op-by-op torch version does on
// the same card.

#pragma once

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

// flag bits of the frame-start rows
#define F_OCCUPIABLE 1
#define F_VEHICLE 2
#define F_CONTROLLED 4
// flag bits of the post-integration rows (F_VEHICLE as above)
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

// The (B, V) fields a frame kernel reads and the ones it writes, in the
// order of ops/straight_frames.py::_IN_FIELDS and _OUT_FIELDS.
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

// vehicle/behavior.py::idm_acceleration masked as the plain frame's accel()
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

// utils/math.py::rects_intersecting_xy_folded for rectangle a against b,
// with a's displacement relative to b over the frame.
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

// One slot's state, in registers for all frames of a policy step.  A
// thread without a slot (i >= V) keeps these padding values.
struct Slot {
  float px = 0.f, py = 0.f, heading = 0.f, speed = 0.f, ts = 0.f, timer = 0.f;
  float ix = 0.f, iy = 0.f, steer = 0.f, acc = 0.f, delta = 4.f;
  float len = 5.f, wid = 2.f, gain = 0.f, max_braking = 0.f;
  int lane = 0, tlane = 0, kind = KIND_PAD;
  bool crashed = false, pend = false, chk = false, coll = false, elc = false;

  __device__ void load(const Fields& f, size_t o) {
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

  __device__ void store(const Fields& f, size_t o) const {
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

  __device__ bool active() const { return kind != KIND_PAD; }
  __device__ bool is_vehicle() const { return kind >= KIND_EGO && kind <= KIND_PLAIN; }
  __device__ bool is_controlled() const { return kind >= KIND_EGO && kind <= KIND_LINEAR; }
};

// Frame-start rows, read by the neighbour and abort scans: START_ARRAYS
// shared-memory arrays of blockDim.x words.
#define START_ARRAYS 11
struct StartRows {
  float *s, *lat, *speed, *ts, *vx, *vy, *cos, *sin;
  int *lane, *tlane, *flags;

  // carves the arrays from p; returns the first word after them
  __device__ float* carve(float* p, int n) {
    s = p;
    lat = s + n;
    speed = lat + n;
    ts = speed + n;
    vx = ts + n;
    vy = vx + n;
    cos = vy + n;
    sin = cos + n;
    lane = reinterpret_cast<int*>(sin + n);
    tlane = lane + n;
    flags = tlane + n;
    return reinterpret_cast<float*>(flags + n);
  }

  // the row of slot j, or the all-zero row of a missing neighbour (j < 0)
  __device__ Row fetch(int j) const {
    Row r;
    r.ex = j >= 0;
    if (r.ex) {
      r.speed = speed[j];
      r.target_speed = ts[j];
      r.s = s[j];
      r.vx = vx[j];
      r.vy = vy[j];
      r.c = cos[j];
      r.sn = sin[j];
      r.vehicle = (flags[j] & F_VEHICLE) != 0;
    } else {
      r.speed = r.target_speed = r.s = r.vx = r.vy = r.c = r.sn = 0.f;
      r.vehicle = false;
    }
    return r;
  }
};

// Post-integration rows, read by the collision pass: POST_ARRAYS arrays.
// len, wid and diag do not change and are staged once per launch.
#define POST_ARRAYS 11
struct PostRows {
  float *px, *py, *speed, *cos, *sin, *vx, *vy, *len, *wid, *diag;
  int* flags;

  __device__ float* carve(float* p, int n) {
    px = p;
    py = px + n;
    speed = py + n;
    cos = speed + n;
    sin = cos + n;
    vx = sin + n;
    vy = vx + n;
    len = vy + n;
    wid = len + n;
    diag = wid + n;
    flags = reinterpret_cast<int*>(diag + n);
    return reinterpret_cast<float*>(flags + n);
  }
};

// One slot's frame-start projection on the road axis and its queries: the
// own lane and the lanes -1 / +1 (clamped), with their offsets.
struct Start {
  float s, lat0, ch, sh, vx, vy;
  bool occ;
  int q_lane[3];
  float q_off[3];
};

__device__ __forceinline__ Start frame_start(const Slot& v, const Geo& g) {
  Start st;
  st.s = (v.px - g.ox) * g.ux + (v.py - g.oy) * g.uy;
  st.lat0 = (v.px - g.ox) * g.nx + (v.py - g.oy) * g.ny;
  st.ch = cosf(v.heading);
  st.sh = sinf(v.heading);
  st.vx = v.speed * st.ch;
  st.vy = v.speed * st.sh;
  st.occ = (-VEHICLE_LENGTH <= st.s) && (st.s < g.in_range_hi) && v.active() &&
           v.kind != KIND_LANDMARK;
  const int L = g.n_lanes;
  st.q_lane[0] = v.lane;
  st.q_lane[1] = clampi(v.lane - 1, 0, L - 1);
  st.q_lane[2] = clampi(v.lane + 1, 0, L - 1);
#pragma unroll
  for (int k = 0; k < 3; ++k) st.q_off[k] = g.offsets[clampi(st.q_lane[k], 0, L - 1)];
  return st;
}

__device__ __forceinline__ void stage_start(const StartRows& r, int i, bool live,
                                            const Slot& v, const Start& st) {
  r.s[i] = st.s;
  r.lat[i] = st.lat0;
  r.speed[i] = v.speed;
  r.ts[i] = v.ts;
  r.vx[i] = st.vx;
  r.vy[i] = st.vy;
  r.cos[i] = st.ch;
  r.sin[i] = st.sh;
  r.lane[i] = v.lane;
  r.tlane[i] = v.tlane;
  r.flags[i] = live ? ((st.occ ? F_OCCUPIABLE : 0) | (v.is_vehicle() ? F_VEHICLE : 0) |
                       (v.is_controlled() ? F_CONTROLLED : 0))
                    : 0;
}

__device__ __forceinline__ void stage_post(const PostRows& c, int i, bool live,
                                           const Slot& v) {
  c.px[i] = v.px;
  c.py[i] = v.py;
  c.speed[i] = v.speed;
  const float c2 = cosf(v.heading), s2 = sinf(v.heading);
  c.cos[i] = c2;
  c.sin[i] = s2;
  c.vx[i] = v.speed * c2;
  c.vy[i] = v.speed * s2;
  c.flags[i] = live ? ((v.active() ? F_ACTIVE : 0) | (v.is_vehicle() ? F_VEHICLE : 0) |
                       (v.chk ? F_CHECK : 0) | (v.coll ? F_COLLIDABLE : 0))
                    : 0;
}

__device__ __forceinline__ bool is_idm(const Slot& v) {
  return v.kind == KIND_IDM && !v.crashed;
}

// Everything a frame does to slot i between the neighbour search and the
// collision pass: MOBIL with its timer, abort-on-conflict (a dense scan of
// the frame-start rows), the steering / speed P-cascade with dual-lane IDM,
// bicycle integration and re-localization on the nearest lane offset.
__device__ void drive(Slot& v, const Start& st, const Row front[3],
                      const Row rear[3], const StartRows& r, int i, int V,
                      const Geo& g, const Params& p) {
  const int L = g.n_lanes;
  const int lane = v.lane, tlane = v.tlane;
  const float s = st.s, lat0 = st.lat0, speed = v.speed;
  const bool idm = is_idm(v);
  const Row self = {speed, v.ts, s, st.vx, st.vy, st.ch, st.sh, true, v.is_vehicle()};

  // --- MOBIL lane change ----------------------------------------------------
  const float a_self = accel_pair(p, g, v.delta, self, front[0]);
  const bool mid_change = lane != tlane;
  const bool deciding = idm && !mid_change && v.timer > p.lane_change_delay && v.elc;
  float new_timer = deciding ? 0.f : v.timer;
  int target = tlane;
  if (deciding) {
    const float a_of = accel_pair(p, g, v.delta, rear[0], self);
    const float a_of_pred = accel_pair(p, g, v.delta, rear[0], front[0]);
    const bool moving = fabsf(speed) >= 1.0f;
#pragma unroll
    for (int k = 1; k < 3; ++k) {
      const int d = k == 1 ? -1 : 1;
      const bool exists = lane + d >= 0 && lane + d < L;
      const float a_nf = accel_pair(p, g, v.delta, rear[k], front[k]);
      const float a_nf_pred = accel_pair(p, g, v.delta, rear[k], self);
      const float a_self_pred = accel_pair(p, g, v.delta, self, front[k]);
      const bool safe = a_nf_pred >= -v.max_braking;
      const float jerk = (a_self_pred - a_self) +
                         p.politeness * (((a_nf_pred - a_nf) + a_of_pred) - a_of);
      const bool reachable = fabsf(lat0 - st.q_off[k]) <= g.reach_lat &&
                             0.f <= s && s < g.in_range_hi;
      if (exists && reachable && moving && safe && jerk >= v.gain) target = st.q_lane[k];
    }
  }
  // abort a lane change into a gap another vehicle is closing
  if (idm && mid_change) {
    bool conflict = false;
    for (int j = 0; j < V && !conflict; ++j) {
      if (j == i || !(r.flags[j] & F_CONTROLLED)) continue;
      if (r.lane[j] == tlane || r.tlane[j] != tlane) continue;
      const float d_ij = r.s[j] - s;
      const float dv = (st.vx - r.vx[j]) * st.ch + (st.vy - r.vy[j]) * st.sh;
      const float d_star = (p.distance_wanted + speed * p.time_wanted) +
                           (speed * dv) * p.inv_two_sqrt_ab;
      conflict = 0.f < d_ij && d_ij < d_star;
    }
    if (conflict) target = lane;
  }

  // --- low-level controls ---------------------------------------------------
  const float lat_t = lat0 - g.offsets[clampi(target, 0, L - 1)];
  const float heading_cmd =
      asinf(clampf((-p.kp_lateral * lat_t) / not_zero(speed), -1.f, 1.f));
  const float heading_ref = g.theta + clampf(heading_cmd, -QUARTER_PI_F, QUARTER_PI_F);
  const float rate = p.kp_heading * wrap_to_pi(heading_ref - v.heading);
  const float slip = asinf(clampf(v.len / 2.f / not_zero(speed) * rate, -1.f, 1.f));
  const float steer_pc =
      clampf(atan2f(2.f * sinf(slip), cosf(slip)), -MAX_STEER_F, MAX_STEER_F);
  // dual-lane IDM while changing lanes
  const int d_t = target - lane;
  const Row& f_t = d_t == 0 ? front[0] : (d_t < 0 ? front[1] : front[2]);
  const float a_t = accel_pair(p, g, v.delta, self, f_t);
  const float a_idm =
      clampf(target != lane ? fminf(a_self, a_t) : a_self, -p.acc_max, p.acc_max);
  const bool is_ego = v.kind == KIND_EGO;
  if (is_ego || idm) v.steer = steer_pc;
  if (is_ego) {
    v.acc = p.kp_a * (v.ts - speed);
  } else if (idm) {
    v.acc = a_idm;
  }
  v.tlane = target;

  // --- bicycle integration and re-localization ------------------------------
  if (v.is_vehicle()) {
    const float st_angle = v.crashed ? 0.f : v.steer;
    float ac = v.crashed ? -1.0f * speed : v.acc;
    ac = speed > MAX_SPEED ? fminf(ac, MAX_SPEED - speed)
                           : (speed < MIN_SPEED ? fmaxf(ac, MIN_SPEED - speed) : ac);
    const float beta = atanf(0.5f * tanf(st_angle));
    const float hb = v.heading + beta;
    v.px = (v.px + (speed * cosf(hb)) * p.dt) + (v.pend ? v.ix : 0.f);
    v.py = (v.py + (speed * sinf(hb)) * p.dt) + (v.pend ? v.iy : 0.f);
    v.crashed = v.crashed || v.pend;
    v.heading = v.heading + speed * sinf(beta) / (v.len / 2.f) * p.dt;
    v.speed = speed + ac * p.dt;
    v.ix = 0.f;
    v.iy = 0.f;
    v.pend = false;
    new_timer = new_timer + p.dt;
    const float lat_new = (v.px - g.ox) * g.nx + (v.py - g.oy) * g.ny;
    int best = 0;
    float best_d = fabsf(lat_new - g.offsets[0]);
    for (int l = 1; l < L; ++l) {
      const float dl = fabsf(lat_new - g.offsets[l]);
      if (dl < best_d) {
        best_d = dl;
        best = l;
      }
    }
    v.lane = best;
  }
  v.timer = new_timer;
}

// The pair's collision gate of the dense pass (road collision protocol):
// both active, one a vehicle, one checking collisions, both collidable.
__device__ __forceinline__ bool pair_eligible(int fa, int fb) {
  return (fa & F_ACTIVE) && (fb & F_ACTIVE) && ((fa & F_VEHICLE) || (fb & F_VEHICLE)) &&
         ((fa & F_CHECK) || (fb & F_CHECK)) && (fa & F_COLLIDABLE) && (fb & F_COLLIDABLE);
}

// Launch of a frame kernel with one block per env, one thread per slot
// (rounded up to a warp) and `words` 4-byte words of shared memory per
// thread.  Returns the CUDA error code.
template <typename Kernel, typename... Args>
int launch_per_env(Kernel kernel, int B, int V, int words, void* stream,
                   Args... args) {
  const int threads = ((V + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(words) * threads * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (B > 0 && V > 0) {
    kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  }
  return static_cast<int>(cudaGetLastError());
}
