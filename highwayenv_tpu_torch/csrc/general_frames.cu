// All frames of one policy step on an analytic-lane road network (straight,
// sine and circular lanes): one warp per group of envs, one thread per
// vehicle slot.  Two kernels from one template: K4 (entry general_frames)
// and K5 (entry general_frames_regulated), K4's frame plus the regulated
// road's right-of-way pass.
//
// Replaces the TPU kernels highwayenv_tpu/ops/general_pallas_bm.py::
// build_general_frame(regulated=False) (K4) and (regulated=True) (K5)
// (pallas_call at :1474, frame body _frame_body_general :473-1352, the
// regulated block :1158-1351).  Semantics are those of
// ops/general_frames.py::frames_general_plain, its plain torch version (the
// JAX package's BaseEnv._frame): per frame follow_road on the lane graph,
// the ego meta-action on frame 0, the IDM / MOBIL decision pass on the
// projection table of every slot on every lane, the steering / speed
// controls, on K5's tick frames the right-of-way pass of
// road/regulation.py, bicycle integration, heading-aware re-localization
// and the swept-SAT collision pass with obstacles and last-write impacts.
// Each operation rounds as the op-by-op torch version does on the same card:
// the library is built with -fmad=false and the precise libm functions, and
// every expression keeps the torch version's order of operations.
//
// What bounds it on an H100: float32 arithmetic and libm calls.  Per frame
// each slot projects itself on every lane (an atan2 and a sqrt per circular
// lane), re-localizes on every lane, scans the other slots of its env for
// neighbours on up to four query lanes and for SAT partners: about 10^4
// operations per slot and frame against ~300 bytes of state per slot and
// policy step, so operations bound it by far.
// What the design does about it: V <= 32 and L <= 32 (the gate), so one warp
// holds floor(32 / V) envs and every exchange between the slots of an env is
// warp-synchronous (__syncwarp, no block barrier per phase, no atomics).  The
// lane tables sit in shared memory once per block, indexed by lane id (the
// TPU kernel's where-chains over L become loads).  Each env keeps its (L, V)
// projection tables S and LAT, its frame-start rows, its post-integration
// rows and its route arrays in shared memory for all frames; each thread
// keeps its own slot in registers.  Device memory is read once and written
// once per policy step.
// K5's right-of-way pass: each env tests its own tick phase, (phase + frame
// + 1) % period == 0, so envs of one batch tick on different frames with no
// masking of frames (the TPU kernel's static-slot schedule, :1414-1464,
// exists because Mosaic cannot branch per env).  On a tick every thread
// predicts its own slot's T = 11 route-walk positions and heading cos / sin
// into shared memory, then tests its slot against every other slot, each
// pair in its (lower, upper) orientation on both of its threads: the
// closeness pre-test takes the lower slot's length and the yield decision
// must be one boolean for the pair, so both threads evaluate the same float
// expressions and no atomics are needed.  The pass writes only the target
// speed and the yielding state, which nothing later in the frame reads.

#include <string.h>

#include "straight_common.cuh"

#define GEN_MAX_LANES 32
#define GEN_MAX_SLOTS 32
#define GEN_MAX_SUCC 4
#define GEN_MAX_EDGE_LANES 8
#define GEN_MAX_SPEEDS 8
#define GEN_MAX_ROUTE 16
#define GEN_WARPS 2  // warps per block
#define KIND_OBSTACLE 5
#define LANE_STRAIGHT 0
#define LANE_SINE 1
#define LANE_CIRCULAR 2
#define HALF_PI_F 1.57079632679489661923f
// road/regulation.py: the prediction times CONFLICT_STEP .. 2.75 s and the
// yield duration in ticks, YIELD_DURATION * REGULATION_FREQUENCY
#define REG_TIMES 11
#define REG_STEP 0.25f
#define REG_YIELD_TICKS 0.0f

// extra flag bits of the post-integration rows (F_ACTIVE, F_VEHICLE, F_CHECK,
// F_COLLIDABLE as in straight_common.cuh)
#define F_SOLID 16
#define F_OBSTACLE 32

// columns of the lane tables (ops/general_frames.py::lane_tables)
enum {
  LF_SX, LF_SY, LF_UX, LF_UY, LF_NX, LF_NY, LF_H0, LF_AMP, LF_PULS, LF_PHASE,
  LF_CX, LF_CY, LF_RAD, LF_SP, LF_CW, LF_WIDTH, LF_LEN, LF_LIMIT, LANE_F_WORDS
};
enum {
  LI_KIND, LI_FORBIDDEN, LI_LANE_ID, LI_EDGE_BASE, LI_EDGE_N, LI_FROM, LI_TO,
  LI_SUCC_BASE, LI_SUCC_N = LI_SUCC_BASE + GEN_MAX_SUCC,
  LI_PRIORITY = LI_SUCC_N + GEN_MAX_SUCC, LANE_I_WORDS
};

struct GenParams {  // ops/general_frames.py::_GenParams
  int L, M, V, R, frames, n_speeds, longitudinal, lateral, period;
  float dt, acc_max, comfort_acc_max, distance_wanted, time_wanted;
  float inv_two_sqrt_ab, politeness, lane_change_delay;
  float kp_a, kp_heading, kp_lateral, tau_pursuit, ts_lo, inv_ts_range;
  float target_speeds[GEN_MAX_SPEEDS];
};

// The (B, V[, ...]) tensors, in the order of ops/general_frames.py::
// _IN_FIELDS, then the slot actions, then OUT_FIELDS.
#define N_IN 28
#define N_OUT 15
struct GenFields {
  const float* pos;
  const float* heading;
  const float* speed;
  const int* lane;
  const int* target_lane;
  const float* target_speed;
  const float* timer;
  const uint8_t* crashed;
  const uint8_t* hit;
  const uint8_t* impact_pending;
  const float* impact;
  const float* steering;
  const float* accel;
  const int* route_ptr;
  const int* speed_index;
  const float* delta;
  const int* kind;
  const float* length;
  const float* width;
  const uint8_t* check_collisions;
  const uint8_t* collidable;
  const uint8_t* enable_lane_change;
  const float* mobil_gain;
  const float* mobil_max_braking;
  const int* route_len;
  const int* route_base;
  const int* route_n;
  const int* route_id;
  const int* action;
  float* pos_out;
  float* heading_out;
  float* speed_out;
  int* lane_out;
  int* target_lane_out;
  float* target_speed_out;
  float* timer_out;
  uint8_t* crashed_out;
  uint8_t* hit_out;
  uint8_t* impact_pending_out;
  float* impact_out;
  float* steering_out;
  float* accel_out;
  int* route_ptr_out;
  int* speed_index_out;
};

// K5's further (B, V) tensors (ops/general_frames.py::REG_FIELDS) and the
// (B,) int32 tick phases steps0 % period: inputs, then outputs.
struct RegFields {
  const uint8_t* is_yielding;
  const int* yield_timer;
  const int* phase;
  uint8_t* is_yielding_out;
  int* yield_timer_out;
};

// The lane tables in shared memory.
struct Lanes {
  const float* f;
  const int* i;
  int L;
  __device__ float F(int l, int k) const { return f[l * LANE_F_WORDS + k]; }
  __device__ int I(int l, int k) const { return i[l * LANE_I_WORDS + k]; }
  __device__ int clip(int l) const { return clampi(l, 0, L - 1); }
};

// road/lane.py::_local_core on lane l (a clipped index)
__device__ void local_coords(const Lanes& g, int l, float px, float py, float* s,
                             float* lat) {
  const int kind = g.I(l, LI_KIND);
  if (kind == LANE_CIRCULAR) {
    const float dcx = px - g.F(l, LF_CX), dcy = py - g.F(l, LF_CY);
    const float sp = g.F(l, LF_SP), cw = g.F(l, LF_CW), rad = g.F(l, LF_RAD);
    const float phi = sp + wrap_to_pi(atan2f(dcy, dcx) - sp);
    const float r = sqrtf(dcx * dcx + dcy * dcy);
    *s = cw * (phi - sp) * rad;
    *lat = cw * (rad - r);
    return;
  }
  const float dx = px - g.F(l, LF_SX), dy = py - g.F(l, LF_SY);
  const float ss = dx * g.F(l, LF_UX) + dy * g.F(l, LF_UY);
  float ll = dx * g.F(l, LF_NX) + dy * g.F(l, LF_NY);
  if (kind == LANE_SINE)
    ll = ll - g.F(l, LF_AMP) * sinf(g.F(l, LF_PULS) * ss + g.F(l, LF_PHASE));
  *s = ss;
  *lat = ll;
}

// road/lane.py::position on lane l
__device__ void lane_position(const Lanes& g, int l, float s, float lat, float* x,
                              float* y) {
  const int kind = g.I(l, LI_KIND);
  if (kind == LANE_CIRCULAR) {
    const float cw = g.F(l, LF_CW), rad = g.F(l, LF_RAD);
    const float phi = cw * s / rad + g.F(l, LF_SP);
    const float rr = rad - lat * cw;
    *x = g.F(l, LF_CX) + rr * cosf(phi);
    *y = g.F(l, LF_CY) + rr * sinf(phi);
    return;
  }
  const float le = kind == LANE_SINE
                       ? lat + g.F(l, LF_AMP) * sinf(g.F(l, LF_PULS) * s + g.F(l, LF_PHASE))
                       : lat;
  *x = g.F(l, LF_SX) + s * g.F(l, LF_UX) + le * g.F(l, LF_NX);
  *y = g.F(l, LF_SY) + s * g.F(l, LF_UY) + le * g.F(l, LF_NY);
}

// road/lane.py::heading_at on lane l
__device__ float lane_heading(const Lanes& g, int l, float s) {
  const int kind = g.I(l, LI_KIND);
  if (kind == LANE_CIRCULAR) {
    const float cw = g.F(l, LF_CW);
    return cw * s / g.F(l, LF_RAD) + g.F(l, LF_SP) + HALF_PI_F * cw;
  }
  if (kind == LANE_SINE)
    return g.F(l, LF_H0) + atanf(g.F(l, LF_AMP) * g.F(l, LF_PULS) *
                                 cosf(g.F(l, LF_PULS) * s + g.F(l, LF_PHASE)));
  return g.F(l, LF_H0);
}

// vehicle/controller.py::next_lane_given_next_edge: the lane taken on an
// edge (base, n) with explicit lane id next_id (-1 = none) by a vehicle whose
// target lane is lt (clipped), from the point (px, py); *dist is the point's
// distance to it (inf for an empty edge).
__device__ int lane_on_edge(const Lanes& g, int lt, int base, int n, int next_id,
                            float px, float py, int M, float* dist) {
  float d[GEN_MAX_EDGE_LANES];
  float best = INFINITY;
  int closest = 0;
  for (int m = 0; m < M; ++m) {
    float dm = INFINITY;
    if (m < n) {
      const int l = g.clip(base + m);
      float s, lat;
      local_coords(g, l, px, py, &s, &lat);
      dm = fabsf(lat) + fmaxf(s - g.F(l, LF_LEN), 0.f) + fmaxf(-s, 0.f);
    }
    d[m] = dm;
    if (dm < best) {  // first minimum
      best = dm;
      closest = m;
    }
  }
  int chosen = g.I(lt, LI_EDGE_N) == n ? (next_id >= 0 ? next_id : g.I(lt, LI_LANE_ID))
                                       : closest;
  chosen = min(max(chosen, 0), max(n - 1, 0));
  *dist = d[min(chosen, M - 1)];
  return base + chosen;
}

// One env's arrays in shared memory: the projection tables S[l * V + j] and
// LAT[l * V + j] of slot j on lane l, the frame-start rows, the
// post-integration rows and the route arrays.
struct EnvSmem {
  float *S, *LAT;
  // frame-start rows (after follow_road and the meta-action)
  float *speed, *ts, *cos, *sin, *vx, *vy;
  int *lane, *tlane, *flags;
  // post-integration rows
  float *px, *py, *pspeed, *pcos, *psin, *pvx, *pvy, *len, *wid, *diag;
  int* pflags;
  // route arrays, slot-major: [j * R + r]
  int *rbase, *rn, *rid;

  __host__ __device__ static int words(int L, int V, int R) {
    return 2 * L * V + 20 * V + 3 * R * V;
  }

  __device__ void carve(float* p, int L, int V, int R) {
    S = p;
    LAT = S + L * V;
    float* q = LAT + L * V;
    float** fs[] = {&speed, &ts, &cos, &sin, &vx, &vy};
    for (float** a : fs) {
      *a = q;
      q += V;
    }
    int** is[] = {&lane, &tlane, &flags};
    for (int** a : is) {
      *a = reinterpret_cast<int*>(q);
      q += V;
    }
    float** ps[] = {&px, &py, &pspeed, &pcos, &psin, &pvx, &pvy, &len, &wid, &diag};
    for (float** a : ps) {
      *a = q;
      q += V;
    }
    pflags = reinterpret_cast<int*>(q);
    q += V;
    rbase = reinterpret_cast<int*>(q);
    rn = rbase + R * V;
    rid = rn + R * V;
  }
};

// One env's arrays of the right-of-way pass in shared memory: every slot's
// predicted position and heading cos / sin at every time, [t * V + j], and
// its frame-start position and lane priority.
struct RegSmem {
  float *px, *py, *pc, *ps, *fx, *fy;
  int* prio;

  __host__ __device__ static int words(int V) { return (4 * REG_TIMES + 3) * V; }

  __device__ void carve(float* p, int V) {
    px = p;
    py = px + REG_TIMES * V;
    pc = py + REG_TIMES * V;
    ps = pc + REG_TIMES * V;
    fx = ps + REG_TIMES * V;
    fy = fx + V;
    prio = reinterpret_cast<int*>(fy + V);
  }
};

// frame-start row flags
#define FS_OCCUPIES 1  // active and not a landmark: may be a neighbour
#define FS_VEHICLE 2
#define FS_CONTROLLED 4

struct Ctx {
  const Lanes& g;
  const GenParams& p;
  const EnvSmem& e;
  int V, i;
  float delta;  // the deciding slot's IDM exponent

  // vehicle/behavior.py::eligible_on_lane of slot j on lane l
  __device__ bool eligible(int l, int j) const {
    const float s = e.S[l * V + j];
    return (e.flags[j] & FS_OCCUPIES) &&
           fabsf(e.LAT[l * V + j]) <= g.F(l, LF_WIDTH) / 2.f + 1.0f &&
           -VEHICLE_LENGTH <= s && s < g.F(l, LF_LEN) + VEHICLE_LENGTH;
  }

  // vehicle/behavior.py::neighbours of slot i on query lane q: front =
  // smallest s >= own s, the last slot among ties; rear = largest s < own s,
  // the first among ties; -1 = none
  __device__ void neighbours(int q, int* front, int* rear) const {
    const int l = g.clip(q);
    const float s_self = e.S[l * V + i];
    float f_key = INFINITY, r_key = -INFINITY;
    int f = -1, r = -1;
    for (int j = 0; j < V; ++j) {
      if (j == i || !eligible(l, j)) continue;
      const float sc = e.S[l * V + j];
      if (s_self <= sc && sc <= f_key) {
        f_key = sc;
        f = j;
      }
      if (sc < s_self && sc > r_key) {
        r_key = sc;
        r = j;
      }
    }
    *front = f;
    *rear = r;
  }

  // vehicle/behavior.py::Rows.accel: IDM acceleration of slot ego behind
  // slot front (-1 = none), with the deciding slot's exponent, the ego's
  // target speed clipped by its current lane's limit and the gap measured on
  // the ego's current lane; 0 where the ego is absent or no vehicle
  __device__ float accel(int ego, int front) const {
    if (ego < 0 || !(e.flags[ego] & FS_VEHICLE)) return 0.f;
    const int el = g.clip(e.lane[ego]);
    const float limit = g.F(el, LF_LIMIT);
    const float ts_raw = e.ts[ego];
    const float ts = isinf(limit) ? ts_raw : fminf(fmaxf(ts_raw, 0.f), limit);
    const float sp = e.speed[ego];
    const float free_acc =
        p.comfort_acc_max * (1.0f - powf(fmaxf(sp, 0.f) / fabsf(not_zero(ts)), delta));
    if (front < 0) return free_acc;
    const float d = e.S[el * V + front] - e.S[el * V + ego];
    const float c = e.cos[ego], sn = e.sin[ego];
    const float dv = (sp * c - e.vx[front]) * c + (sp * sn - e.vy[front]) * sn;
    const float d_star =
        (p.distance_wanted + sp * p.time_wanted) + (sp * dv) * p.inv_two_sqrt_ab;
    const float qd = d_star / not_zero(d);
    return free_acc - p.comfort_acc_max * (qd * qd);
  }
};

// One slot's state, in registers for all frames of the policy step.
struct GSlot {
  float px = 0.f, py = 0.f, heading = 0.f, speed = 0.f, ts = 0.f, timer = 0.f;
  float ix = 0.f, iy = 0.f, steer = 0.f, acc = 0.f, delta = 4.f;
  float len = 5.f, wid = 2.f, gain = 0.f, max_braking = 0.f;
  int lane = 0, tlane = 0, kind = KIND_PAD, route_ptr = 0, route_len = 0;
  int speed_index = 0, action = 0, yt = 0;
  bool crashed = false, hit = false, pend = false, chk = false, coll = false,
       elc = false, yld = false;

  __device__ bool active() const { return kind != KIND_PAD; }
  __device__ bool is_vehicle() const { return kind >= KIND_EGO && kind <= KIND_PLAIN; }
  __device__ bool is_controlled() const { return kind >= KIND_EGO && kind <= KIND_LINEAR; }
};

// Any of the 9 probe points (corners, edge midpoints, centre) of the
// rectangle a (centre, length, width, heading cos / sin) inside the
// rectangle b: regulation.py::_one_way.
__device__ bool probes_inside(float ax, float ay, float la, float wa, float ca, float sa,
                              float bx, float by, float lb, float wb, float cb,
                              float sb) {
  const float fxs[9] = {-0.5f, -0.5f, 0.5f, 0.5f, 0.0f, -0.5f, 0.5f, 0.0f, 0.0f};
  const float fys[9] = {-0.5f, 0.5f, 0.5f, -0.5f, 0.0f, 0.0f, 0.0f, -0.5f, 0.5f};
  for (int k = 0; k < 9; ++k) {
    const float lx = fxs[k] * la, ly = fys[k] * wa;
    const float ppx = ax + ca * lx - sa * ly;
    const float ppy = ay + sa * lx + ca * ly;
    const float dxp = ppx - bx, dyp = ppy - by;
    const float rx = cb * dxp - sb * dyp;
    const float ry = sb * dxp + cb * dyp;
    if (-lb / 2.f <= rx && rx <= lb / 2.f && -wb / 2.f <= ry && ry <= wb / 2.f) return true;
  }
  return false;
}

// road/regulation.py::enforce_road_rules for slot i of one env.  Every
// thread of the warp calls it (the barrier inside); `tick` is the env's own
// tick test and false on threads that hold no slot.  Reads the frame-start
// state (after follow_road and the meta-action), writes v.ts, v.yld, v.yt.
__device__ void regulate(const Lanes& g, const EnvSmem& e, const RegSmem& r, GSlot& v,
                         const int* rb, const int* rn, const int* rid, int V, int R, int i,
                         bool tick) {
  if (tick) {
    // the constant-speed route walk (predict_route_positions)
    const int lc = g.clip(v.lane);
    const float s0 = e.S[lc * V + i];
    const bool has_rt = v.route_ptr < v.route_len;
    const int cur_id = g.I(lc, LI_LANE_ID);
    float cum[GEN_MAX_ROUTE];
    int seg[GEN_MAX_ROUTE];
    unsigned valid = 0u;
    float acc = 0.f;
    int n_valid = 0, first = -1;
    for (int q = 0; q < R; ++q) {
      const bool ok = has_rt && q >= v.route_ptr && q < v.route_len;
      const int fallback = cur_id < rn[q] ? cur_id : 0;
      const int seg_id = rid[q] >= 0 ? rid[q] : fallback;
      seg[q] = ok ? clampi(rb[q] + seg_id, 0, g.L - 1) : v.lane;
      acc = acc + (ok ? g.F(g.clip(seg[q]), LF_LEN) : 0.f);
      cum[q] = acc;
      if (ok) {
        valid |= 1u << q;
        ++n_valid;
        if (first < 0) first = q;
      }
    }
    first = max(first, 0);
    const int last = n_valid > 0 ? first + n_valid - 1 : 0;
    for (int t = 0; t < REG_TIMES; ++t) {
      const float target = s0 + v.speed * (REG_STEP * static_cast<float>(t + 1));
      int k = first;
      for (int q = 0; q < R; ++q)
        if (target > cum[q] && q < last && ((valid >> q) & 1u)) ++k;
      k = min(k, last);
      const int lk = g.clip(seg[k]);
      const float base = k > first ? cum[k - 1] : 0.f;
      const float s_loc = target - base;
      float x, y;
      lane_position(g, lk, s_loc, 0.f, &x, &y);
      const float h = lane_heading(g, lk, s_loc);
      r.px[t * V + i] = x;
      r.py[t * V + i] = y;
      r.pc[t * V + i] = cosf(h);
      r.ps[t * V + i] = sinf(h);
    }
    r.fx[i] = v.px;
    r.fy[i] = v.py;
    r.prio[i] = g.I(lc, LI_PRIORITY);
  }
  __syncwarp();
  if (!tick) return;

  // future overlaps with every other vehicle, each pair as (lower, upper)
  bool new_yield = false;
  if (e.flags[i] & FS_VEHICLE) {
    for (int j = 0; j < V; ++j) {
      if (j == i || !(e.flags[j] & FS_VEHICLE)) continue;
      const int a = min(i, j), b = max(i, j);
      const float la = 1.5f * e.len[a], wa = 0.9f * e.wid[a];
      const float lb = 1.5f * e.len[b], wb = 0.9f * e.wid[b];
      const float reach2 = e.len[a] * e.len[a];
      bool conflict = false;
      for (int t = 0; t < REG_TIMES && !conflict; ++t) {
        const int ta = t * V + a, tb = t * V + b;
        const float dx = r.px[tb] - r.px[ta], dy = r.py[tb] - r.py[ta];
        if (!(dx * dx + dy * dy <= reach2)) continue;
        conflict = probes_inside(r.px[ta], r.py[ta], la, wa, r.pc[ta], r.ps[ta], r.px[tb],
                                 r.py[tb], lb, wb, r.pc[tb], r.ps[tb]) ||
                   probes_inside(r.px[tb], r.py[tb], lb, wb, r.pc[tb], r.ps[tb], r.px[ta],
                                 r.py[ta], la, wa, r.pc[ta], r.ps[ta]);
      }
      if (!conflict) continue;
      // the lower priority yields; on a tie the one less far ahead
      const int pa = r.prio[a], pb = r.prio[b];
      bool a_yields;
      if (pa != pb) {
        a_yields = pa < pb;
      } else {
        const float dx0 = r.fx[b] - r.fx[a], dy0 = r.fy[b] - r.fy[a];
        const float front_ab = dx0 * e.cos[a] + dy0 * e.sin[a];
        const float front_ba = (-dx0) * e.cos[b] + (-dy0) * e.sin[b];
        a_yields = front_ab > front_ba;
      }
      new_yield = new_yield || (i == a ? a_yields : !a_yields);
    }
  }
  new_yield = new_yield && (v.kind == KIND_IDM || v.kind == KIND_LINEAR);

  // release the expired yielders to the lane's limit, then the new yields
  const bool expired = v.yld && static_cast<float>(v.yt) >= REG_YIELD_TICKS;
  if (expired) v.ts = g.F(g.clip(v.lane), LF_LIMIT);
  if (v.yld && !expired) v.yt = v.yt + 1;
  v.yld = v.yld && !expired;
  if (new_yield) {
    v.ts = 0.f;
    v.yt = 0;
    v.yld = true;
  }
}

template <bool kRegulated>
__global__ void general_frames_kernel(GenFields f, RegFields rf, const float* lane_f,
                                      const int* lane_i, GenParams p, int B) {
  extern __shared__ float smem[];
  const int L = p.L, V = p.V, R = p.R, M = p.M;

  // the lane tables, once per block
  float* lf = smem;
  int* li = reinterpret_cast<int*>(lf + L * LANE_F_WORDS);
  for (int k = threadIdx.x; k < L * LANE_F_WORDS; k += blockDim.x) lf[k] = lane_f[k];
  for (int k = threadIdx.x; k < L * LANE_I_WORDS; k += blockDim.x) li[k] = lane_i[k];
  __syncthreads();
  const Lanes g = {lf, li, L};

  const int warp = threadIdx.x / 32, t = threadIdx.x % 32;
  const int per_warp = 32 / V;  // envs per warp
  const int env_in_warp = t / V;
  const int i = t % V;
  const int env = (blockIdx.x * GEN_WARPS + warp) * per_warp + env_in_warp;
  const bool live = env_in_warp < per_warp && env < B;

  EnvSmem e;
  RegSmem r;
  const int env_words = EnvSmem::words(L, V, R) + (kRegulated ? RegSmem::words(V) : 0);
  float* env_base = reinterpret_cast<float*>(li + L * LANE_I_WORDS) +
                    static_cast<size_t>(warp * per_warp + (live ? env_in_warp : 0)) *
                        env_words;
  e.carve(env_base, L, V, R);
  if constexpr (kRegulated) r.carve(env_base + EnvSmem::words(L, V, R), V);
  const int phase = (kRegulated && live) ? rf.phase[env] : 0;

  const size_t o = static_cast<size_t>(env) * V + i;
  GSlot v;
  if (live) {
    v.px = f.pos[2 * o];
    v.py = f.pos[2 * o + 1];
    v.heading = f.heading[o];
    v.speed = f.speed[o];
    v.lane = f.lane[o];
    v.tlane = f.target_lane[o];
    v.ts = f.target_speed[o];
    v.timer = f.timer[o];
    v.crashed = f.crashed[o] != 0;
    v.hit = f.hit[o] != 0;
    v.pend = f.impact_pending[o] != 0;
    v.ix = f.impact[2 * o];
    v.iy = f.impact[2 * o + 1];
    v.steer = f.steering[o];
    v.acc = f.accel[o];
    v.route_ptr = f.route_ptr[o];
    v.speed_index = f.speed_index[o];
    v.delta = f.delta[o];
    v.kind = f.kind[o];
    v.len = f.length[o];
    v.wid = f.width[o];
    v.chk = f.check_collisions[o] != 0;
    v.coll = f.collidable[o] != 0;
    v.elc = f.enable_lane_change[o] != 0;
    v.gain = f.mobil_gain[o];
    v.max_braking = f.mobil_max_braking[o];
    v.route_len = f.route_len[o];
    v.action = f.action[o];
    if constexpr (kRegulated) {
      v.yld = rf.is_yielding[o] != 0;
      v.yt = rf.yield_timer[o];
    }
    for (int r = 0; r < R; ++r) {
      e.rbase[i * R + r] = f.route_base[o * R + r];
      e.rn[i * R + r] = f.route_n[o * R + r];
      e.rid[i * R + r] = f.route_id[o * R + r];
    }
    e.len[i] = v.len;
    e.wid[i] = v.wid;
    e.diag[i] = sqrtf(v.len * v.len + v.wid * v.wid);
    // the frame-start projection table: this slot on every lane
    for (int l = 0; l < L; ++l) local_coords(g, l, v.px, v.py, &e.S[l * V + i], &e.LAT[l * V + i]);
  }
  __syncwarp();

  const Ctx cx = {g, p, e, V, i, v.delta};
  const int* rb = e.rbase + i * R;
  const int* rn = e.rn + i * R;
  const int* rid = e.rid + i * R;

  for (int frame = 0; frame < p.frames; ++frame) {
    // --- A: follow_road, then the ego meta-action on frame 0 --------------
    if (live) {
      const int lt = g.clip(v.tlane);
      const float s_t = e.S[lt * V + i];
      const bool ended = s_t > g.F(lt, LF_LEN) - VEHICLE_LENGTH / 2.f;
      if (ended && v.is_controlled()) {
        float projx, projy;
        lane_position(g, lt, s_t, 0.f, &projx, &projy);
        const int ptr = v.route_ptr;
        const bool pop = ptr < v.route_len &&
                         rb[clampi(ptr, 0, R - 1)] == g.I(lt, LI_EDGE_BASE);
        const int new_ptr = pop ? ptr + 1 : ptr;
        const int hp = clampi(new_ptr, 0, R - 1);
        const int head_base = rb[hp];
        const bool follow = new_ptr < v.route_len &&
                            g.I(g.clip(head_base), LI_FROM) == g.I(lt, LI_TO);
        float dist;
        int next;
        if (follow) {
          next = lane_on_edge(g, lt, head_base, rn[hp], rid[hp], projx, projy, M, &dist);
        } else {
          // the lane of the successor edge closest to the projected point,
          // the first minimum; with no successor the lane is kept
          float best = INFINITY;
          next = v.tlane;
          for (int k = 0; k < GEN_MAX_SUCC; ++k) {
            const int sb = g.I(lt, LI_SUCC_BASE + k);
            if (sb < 0) continue;
            const int cl = lane_on_edge(g, lt, sb, g.I(lt, LI_SUCC_N + k), -1, projx,
                                        projy, M, &dist);
            if (dist < best) {
              best = dist;
              next = cl;
            }
          }
        }
        v.tlane = next;
        v.route_ptr = new_ptr;
      }
      if (frame == 0 && v.kind == KIND_EGO) {
        const int a = v.action;
        bool ll, lr, fa, sl;
        if (p.longitudinal && p.lateral) {
          ll = a == 0;
          lr = a == 2;
          fa = a == 3;
          sl = a == 4;
        } else if (p.longitudinal) {
          ll = lr = false;
          fa = a == 2;
          sl = a == 0;
        } else {
          ll = a == 0;
          lr = a == 2;
          fa = sl = false;
        }
        const float n1 = static_cast<float>(p.n_speeds - 1);
        const int cur =
            static_cast<int>(clampf(rintf(((v.speed - p.ts_lo) * p.inv_ts_range) * n1), 0.f, n1));
        const int idx = clampi(fa ? cur + 1 : (sl ? cur - 1 : v.speed_index), 0, p.n_speeds - 1);
        if (fa || sl) v.ts = p.target_speeds[idx];
        v.speed_index = idx;
        const int lt2 = g.clip(v.tlane);
        const int d_id = lr ? 1 : (ll ? -1 : 0);
        const int cand = g.I(lt2, LI_EDGE_BASE) +
                         min(max(g.I(lt2, LI_LANE_ID) + d_id, 0), g.I(lt2, LI_EDGE_N) - 1);
        const int cl = g.clip(cand);
        const float s_c = e.S[cl * V + i], lat_c = e.LAT[cl * V + i];
        const bool reach = fabsf(lat_c) <= 2.f * g.F(cl, LF_WIDTH) && 0.f <= s_c &&
                           s_c < g.F(cl, LF_LEN) + VEHICLE_LENGTH &&
                           !g.I(cl, LI_FORBIDDEN);
        if ((ll || lr) && reach) v.tlane = cand;
      }
      const float ch = cosf(v.heading), sh = sinf(v.heading);
      e.speed[i] = v.speed;
      e.ts[i] = v.ts;
      e.cos[i] = ch;
      e.sin[i] = sh;
      e.vx[i] = v.speed * ch;
      e.vy[i] = v.speed * sh;
      e.lane[i] = v.lane;
      e.tlane[i] = v.tlane;
      e.flags[i] = ((v.active() && v.kind != KIND_LANDMARK) ? FS_OCCUPIES : 0) |
                   (v.is_vehicle() ? FS_VEHICLE : 0) |
                   (v.is_controlled() ? FS_CONTROLLED : 0);
    }
    __syncwarp();

    // --- B: the IDM / MOBIL decision pass and the controls ----------------
    if (live) {
      const bool idm = v.kind == KIND_IDM && !v.crashed;
      const int lane = v.lane, tlane = v.tlane;
      const int lc = g.clip(lane), tc = g.clip(tlane);
      const bool mid_change = lane != tlane;
      const float speed = v.speed;
      int target = tlane;
      float a_idm = 0.f;
      if (idm) {
        int cur_front, cur_rear;
        cx.neighbours(lane, &cur_front, &cur_rear);
        const float a_self = cx.accel(i, cur_front);
        const bool deciding = !mid_change && v.timer > p.lane_change_delay && v.elc;
        if (deciding) {
          v.timer = 0.f;
          const float a_of = cx.accel(cur_rear, i);
          const float a_of_pred = cx.accel(cur_rear, cur_front);
          const int head_id = rid[clampi(v.route_ptr, 0, R - 1)];
          const bool has_rid = v.route_ptr < v.route_len && head_id >= 0;
          const int tgt_id = g.I(tc, LI_LANE_ID);
          const bool moving = fabsf(speed) >= 1.0f;
          for (int d = -1; d <= 1; d += 2) {
            const int cand_id = g.I(lc, LI_LANE_ID) + d;
            const bool exists = cand_id >= 0 && cand_id < g.I(lc, LI_EDGE_N);
            const int cand = g.clip(g.I(lc, LI_EDGE_BASE) + cand_id);
            const float s_c = e.S[cand * V + i], lat_c = e.LAT[cand * V + i];
            const bool reachable = fabsf(lat_c) <= 2.f * g.F(cand, LF_WIDTH) && 0.f <= s_c &&
                                   s_c < g.F(cand, LF_LEN) + VEHICLE_LENGTH &&
                                   !g.I(cand, LI_FORBIDDEN);
            if (!(exists && reachable && moving)) continue;
            int new_front, new_rear;
            cx.neighbours(cand, &new_front, &new_rear);
            const float a_nf_pred = cx.accel(new_rear, i);
            const bool safe = a_nf_pred >= -v.max_braking;
            const float a_self_pred = cx.accel(i, new_front);
            const int dc = g.I(cand, LI_LANE_ID) - tgt_id, dh = head_id - tgt_id;
            const bool route_ok = ((dc > 0) - (dc < 0)) == ((dh > 0) - (dh < 0)) &&
                                  a_self_pred >= -v.max_braking;
            const float a_nf = cx.accel(new_rear, new_front);
            const float jerk = (a_self_pred - a_self) +
                               p.politeness * (((a_nf_pred - a_nf) + a_of_pred) - a_of);
            if (safe && (has_rid ? route_ok : jerk >= v.gain)) target = cand;
          }
        }
        // abort a lane change into a gap another controlled vehicle is
        // closing, on the same road only
        if (mid_change && g.I(lc, LI_EDGE_BASE) == g.I(tc, LI_EDGE_BASE)) {
          const float s_self = e.S[lc * V + i];
          const float ch = e.cos[i], sh = e.sin[i], vxi = e.vx[i], vyi = e.vy[i];
          bool conflict = false;
          for (int j = 0; j < V && !conflict; ++j) {
            if (j == i || !(e.flags[j] & FS_CONTROLLED)) continue;
            if (e.lane[j] == tlane || e.tlane[j] != tlane) continue;
            const float d_ij = e.S[lc * V + j] - s_self;
            const float dv = (vxi - e.vx[j]) * ch + (vyi - e.vy[j]) * sh;
            const float d_star =
                (p.distance_wanted + speed * p.time_wanted) + (speed * dv) * p.inv_two_sqrt_ab;
            conflict = 0.f < d_ij && d_ij < d_star;
          }
          if (conflict) target = lane;
        }
        // the dual-lane IDM minimum while changing lanes
        a_idm = a_self;
        if (lane != target) {
          int t_front, t_rear;
          cx.neighbours(target, &t_front, &t_rear);
          a_idm = fminf(a_self, cx.accel(i, t_front));
        }
        a_idm = clampf(a_idm, -p.acc_max, p.acc_max);
      }
      v.tlane = target;
      const bool is_ego = v.kind == KIND_EGO;
      if (is_ego || idm) {
        // steering toward the target lane's heading a pursuit distance ahead
        const int tg = g.clip(target);
        const float s = e.S[tg * V + i], lat = e.LAT[tg * V + i];
        const float future = lane_heading(g, tg, s + speed * p.tau_pursuit);
        const float heading_cmd =
            asinf(clampf((-p.kp_lateral * lat) / not_zero(speed), -1.f, 1.f));
        const float heading_ref = future + clampf(heading_cmd, -QUARTER_PI_F, QUARTER_PI_F);
        const float rate = p.kp_heading * wrap_to_pi(heading_ref - v.heading);
        const float slip = asinf(clampf(v.len / 2.f / not_zero(speed) * rate, -1.f, 1.f));
        v.steer = clampf(atan2f(2.f * sinf(slip), cosf(slip)), -MAX_STEER_F, MAX_STEER_F);
        v.acc = is_ego ? p.kp_a * (v.ts - speed) : a_idm;
      }
    }
    __syncwarp();  // the frame-start tables and rows are read

    // --- B': the right-of-way pass on the env's tick frames ----------------
    if constexpr (kRegulated)
      regulate(g, e, r, v, rb, rn, rid, V, R, i,
               live && (phase + frame + 1) % p.period == 0);

    // --- C: integration, the new projection table, re-localization --------
    if (live) {
      if (v.is_vehicle()) {
        const float speed = v.speed;
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
        v.timer = v.timer + p.dt;
      }
      // closest lane by |lat| + overrun + heading distance, first minimum
      float best = INFINITY;
      int best_l = 0;
      for (int l = 0; l < L; ++l) {
        float s, lat;
        local_coords(g, l, v.px, v.py, &s, &lat);
        e.S[l * V + i] = s;
        e.LAT[l * V + i] = lat;
        const float dl = fabsf(lat) + fmaxf(s - g.F(l, LF_LEN), 0.f) + fmaxf(-s, 0.f) +
                         1.0f * fabsf(wrap_to_pi(v.heading - lane_heading(g, l, s)));
        if (l == 0 || dl < best) {
          best = dl;
          best_l = l;
        }
      }
      if (v.is_vehicle()) v.lane = best_l;
      const float ch = cosf(v.heading), sh = sinf(v.heading);
      e.px[i] = v.px;
      e.py[i] = v.py;
      e.pspeed[i] = v.speed;
      e.pcos[i] = ch;
      e.psin[i] = sh;
      e.pvx[i] = v.speed * ch;
      e.pvy[i] = v.speed * sh;
      const bool solid = v.active() && v.kind != KIND_LANDMARK;
      e.pflags[i] = (v.active() ? F_ACTIVE : 0) | (v.is_vehicle() ? F_VEHICLE : 0) |
                    (v.chk ? F_CHECK : 0) | (v.coll ? F_COLLIDABLE : 0) |
                    (solid ? F_SOLID : 0) | (v.kind == KIND_OBSTACLE ? F_OBSTACLE : 0);
    }
    __syncwarp();

    // --- D: collisions: sphere pre-check, swept SAT, last-write impacts ----
    if (live) {
      const int fi = e.pflags[i];
      bool crash = false, hit = false;
      int row_j = -1, col_j = -1;
      float row_tx = 0.f, row_ty = 0.f, col_tx = 0.f, col_ty = 0.f;
      for (int j = 0; j < V; ++j) {
        if (j == i) continue;
        const int a = min(i, j), b = max(i, j);  // a = the pair's ``self``
        const int fa = e.pflags[a], fb = e.pflags[b];
        if (!pair_eligible(fa, fb)) continue;
        const float dx = e.px[a] - e.px[b], dy = e.py[a] - e.py[b];
        const float reach = (e.diag[a] + e.diag[b]) / 2.f + e.pspeed[a] * p.dt;
        if (!(dx * dx + dy * dy <= reach * reach)) continue;
        bool inter, will;
        float tx, ty;
        sat(e.px[a], e.py[a], e.len[a], e.wid[a], e.pcos[a], e.psin[a], e.px[b], e.py[b],
            e.len[b], e.wid[b], e.pcos[b], e.psin[b], (e.pvx[a] - e.pvx[b]) * p.dt,
            (e.pvy[a] - e.pvy[b]) * p.dt, &inter, &will, &tx, &ty);
        const bool both_solid = (fa & F_SOLID) && (fb & F_SOLID);
        crash = crash || (inter && both_solid);
        hit = hit || (inter && !(fi & F_SOLID));
        if (will && both_solid && !(fi & F_OBSTACLE)) {
          // the full translation against an obstacle, half each between
          // two vehicles; ascending j: the last write is the max partner
          const bool other_obstacle = (e.pflags[j] & F_OBSTACLE) != 0;
          if (j > i) {
            const float coef = other_obstacle ? 1.0f : 0.5f;
            row_j = j;
            row_tx = coef * tx;
            row_ty = coef * ty;
          } else {
            const float coef = other_obstacle ? 1.0f : -0.5f;
            col_j = j;
            col_tx = coef * tx;
            col_ty = coef * ty;
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
      v.crashed = v.crashed || crash;
      v.hit = v.hit || hit;
    }
    // the next frame's phase A writes only frame-start rows, which nobody
    // reads until after its barrier; phase C's writes come after two more
  }

  if (live) {
    f.pos_out[2 * o] = v.px;
    f.pos_out[2 * o + 1] = v.py;
    f.heading_out[o] = v.heading;
    f.speed_out[o] = v.speed;
    f.lane_out[o] = v.lane;
    f.target_lane_out[o] = v.tlane;
    f.target_speed_out[o] = v.ts;
    f.timer_out[o] = v.timer;
    f.crashed_out[o] = v.crashed ? 1 : 0;
    f.hit_out[o] = v.hit ? 1 : 0;
    f.impact_pending_out[o] = v.pend ? 1 : 0;
    f.impact_out[2 * o] = v.ix;
    f.impact_out[2 * o + 1] = v.iy;
    f.steering_out[o] = v.steer;
    f.accel_out[o] = v.acc;
    f.route_ptr_out[o] = v.route_ptr;
    f.speed_index_out[o] = v.speed_index;
    if constexpr (kRegulated) {
      rf.is_yielding_out[o] = v.yld ? 1 : 0;
      rf.yield_timer_out[o] = v.yt;
    }
  }
}

template <bool kRegulated>
static int launch(void* const* ptrs, const RegFields& rf, const float* lane_f,
                  const int* lane_i, const GenParams* params, int B, void* stream) {
  static_assert(sizeof(GenFields) == (N_IN + 1 + N_OUT) * sizeof(void*),
                "GenFields holds one pointer per tensor");
  const GenParams& p = *params;
  if (p.V < 1 || p.V > GEN_MAX_SLOTS || p.L < 1 || p.L > GEN_MAX_LANES || p.R < 1 ||
      p.R > GEN_MAX_ROUTE || p.M < 1 || p.M > GEN_MAX_EDGE_LANES || p.n_speeds < 1 ||
      p.n_speeds > GEN_MAX_SPEEDS || (kRegulated && p.period < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  GenFields f;
  memcpy(&f, ptrs, sizeof(GenFields));
  const int envs_per_block = GEN_WARPS * (32 / p.V);
  const size_t env_words =
      EnvSmem::words(p.L, p.V, p.R) + (kRegulated ? RegSmem::words(p.V) : 0);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(p.L) * LANE_F_WORDS +
                       static_cast<size_t>(p.L) * LANE_I_WORDS +
                       static_cast<size_t>(envs_per_block) * env_words);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(general_frames_kernel<kRegulated>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (B > 0) {
    const int blocks = (B + envs_per_block - 1) / envs_per_block;
    general_frames_kernel<kRegulated>
        <<<blocks, GEN_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
            f, rf, lane_f, lane_i, p, B);
  }
  return static_cast<int>(cudaGetLastError());
}

// ptrs: the N_IN input tensors, the (B, V) int32 slot actions and the N_OUT
// output tensors, as device pointers in GenFields' order; lane_f / lane_i:
// the (L, LANE_F_WORDS) float and (L, LANE_I_WORDS) int lane tables on the
// device.  Launches K4 on `stream` without synchronizing; returns the CUDA
// error code (cudaErrorInvalidValue for shapes outside the kernel's limits).
extern "C" int general_frames(void* const* ptrs, const float* lane_f, const int* lane_i,
                              const GenParams* params, int B, void* stream) {
  return launch<false>(ptrs, RegFields{}, lane_f, lane_i, params, B, stream);
}

// K5: as general_frames, plus reg_ptrs, the device pointers of RegFields in
// its order.
extern "C" int general_frames_regulated(void* const* ptrs, void* const* reg_ptrs,
                                        const float* lane_f, const int* lane_i,
                                        const GenParams* params, int B, void* stream) {
  static_assert(sizeof(RegFields) == 5 * sizeof(void*), "RegFields holds five pointers");
  RegFields rf;
  memcpy(&rf, reg_ptrs, sizeof(RegFields));
  return launch<true>(ptrs, rf, lane_f, lane_i, params, B, stream);
}
