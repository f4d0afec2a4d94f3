// Device code shared by the dense (straight_frames.cu) and the s-sorted
// banded (straight_frames_sorted.cu) frame kernels: the constants, the
// geometry and IDM parameters, the field pointers, one slot's registers,
// the rows and lane-mask words staged in shared memory, the IDM acceleration
// of a row pair, the folded swept SAT, the set-bit walk, and one slot's
// MOBIL decision, controls, bicycle integration and re-localization.  The
// two kernels differ only in how they find neighbours and collision
// partners, so everything a frame does around those two searches lives here
// and the kernels cannot drift apart.
//
// Semantics are those of ops/straight_frames.py (frames_plain and its
// phases).  The lean instantiations specialize them to the scenes the
// straight highway envs spawn, vehicles only, with IDM and Linear NPCs; the
// dense kernel's objects instantiations (Params::objects, the TPU kernel's
// non-lean branch) also take obstacle and landmark rows, which the lean
// ones trap on (trap_on_kinds).  The frame code here reads every row's kind
// already (a landmark occupies no lane, only vehicles integrate, a pair
// needs a vehicle); the objects resolution of a collision lives in
// straight_frames.cu.  A Linear row
// (kind KIND_LINEAR, the TPU kernels' has_linear branch,
// straight_pallas_bm.py:569-573, :697-707, :857-862) decides with
// LinearVehicle's acceleration in every pair it evaluates, its own law and
// parameters even where the pair's ego is a neighbour, and steers by
// LinearVehicle's law; the law goes by the row's kind, as the JAX package's
// XLA frame decides it.  Each kernel has two instantiations of the law
// (K1 each of them lean and objects): with
// Params::linear the one whose drive() reads each row's kind (LinearSlot),
// without it the IDM code alone (Slot: the parent's code, so an IDM-only
// scene pays nothing for the branch), which traps where it meets a Linear
// row (trap_on_kinds).  Under Params::raw (a ContinuousAction) the ego
// keeps its stored steering and acc, the TPU kernels' raw_controls branch.
// Rounding: the kernels are built with -fmad=false and the precise libm
// functions, so every operation rounds as the op-by-op torch version does on
// the same card.
//
// What bounds a frame on the H100: issue slots and the latency of dependent
// shared-memory loads, not bytes or float operations.  Thread 0's clock64()
// split of a highway-v0 frame (V = 51, tools/kernel_ab.py --clocks) put
// drive() first in both kernels (42% of the dense kernel's frame, 37.5% of
// the sorted one's), then the pair searches and the sorted kernel's scans.
// What the code here does about it: every pair search walks only the set
// bits of per-warp ballot words (lane membership, the abort scan's
// candidates, the collision gate) in ascending slot order, which keeps the
// dense pass's tie rules; drive() evaluates IDM's free-road term (a precise
// powf) once per ego row, not once per pair, and fetches each neighbour's
// row where it reads it; the heading's cosf / sinf are carried from one
// frame's stage_post to the next frame's frame_start; the rows are
// 16-byte-aligned structs behind one base pointer, so a fetch is two
// 128-bit loads and the arrays hold few registers; the kernels take their
// parameter structs as __grid_constant__ (no copy to the stack).  Built for
// up to 1024 threads a block (__launch_bounds__), a thread gets 64
// registers, so 16 blocks of two warps share an SM at V = 51; the few
// values that spill are reloaded once a frame or around the slow path of a
// precise division, and a build of the same code without the cap (79 and
// 100 registers, no spills, 12 and 9 blocks an SM) runs slower (PERF.md).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_BLOCK_THREADS 1024
#define FULL_MASK 0xffffffffu
#define KIND_PAD 0
#define KIND_EGO 1
#define KIND_IDM 2
#define KIND_LINEAR 3
#define KIND_PLAIN 4
#define KIND_OBSTACLE 5
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
#define F_VEHICLE 2
#define F_CONTROLLED 4
// flag bits of the general frame kernel's post-integration rows
// (general_frames.cu; F_VEHICLE as above)
#define F_ACTIVE 1
#define F_CHECK 4
#define F_COLLIDABLE 8
// the object bits of a row: solid (active, not a landmark) and an obstacle;
// in the general kernel's flags and the straight K1's objects
// instantiation's PostRow::obj
#define F_SOLID 16
#define F_OBSTACLE 32

struct Geo {  // ops/straight_frames.py::_Geo
  float ox, oy, ux, uy, nx, ny;
  float theta;        // lane heading
  float in_range_hi;  // road length + VEHICLE_LENGTH
  float member_tol;   // lane membership: |lat - off| <= width / 2 + 1
  float reach_lat;    // MOBIL reachability: |lat - off| <= 2 width
  float speed_limit;
  int has_limit;
  int n_lanes;
  // the n_lanes lateral lane offsets on the device; each block copies them
  // to the head of its shared memory (load_lane_offsets), where lane_offset
  // reads them, so the scene's lane count sizes the table
  const float* offsets;
};

// The block's dynamic shared memory: its first lane_offset_words(L) words
// hold the lane offsets, the frame kernels' rows follow.
extern __shared__ __align__(16) float straight_smem[];
__host__ __device__ __forceinline__ int lane_offset_words(int L) { return (L + 3) & ~3; }
__device__ __forceinline__ float lane_offset(int l) { return straight_smem[l]; }

// Copies the lane offsets into shared memory; every thread of the block
// calls it, and a barrier follows before the first lane_offset.
__device__ __forceinline__ void load_lane_offsets(const Geo& g) {
  for (int l = threadIdx.x; l < g.n_lanes; l += blockDim.x) straight_smem[l] = g.offsets[l];
}

struct Params {  // ops/straight_frames.py::_Params
  float dt;
  float acc_max, comfort_acc_max, distance_wanted, time_wanted;
  float inv_two_sqrt_ab, politeness, lane_change_delay;
  float kp_a, kp_heading, kp_lateral;
  int raw;      // 1: egos keep their stored steering and acc (ContinuousAction)
  int linear;   // 1: Linear rows possible (the Linear rows' instantiation)
  int objects;  // 1: obstacle and landmark rows possible (K1's objects instantiation)
  // the objects instantiation's (B, V) hit field, read and written
  const uint8_t* hit;
  uint8_t* hit_out;
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
  const float* accel_params;  // (B, V, 3), read on Linear rows only
  const float* steer_params;  // (B, V, 2), read on Linear rows only
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

// The deciding row's laws: IDM's and the P-cascade, or LinearVehicle's
// with its acceleration parameters theta (vehicle/behavior.py::
// linear_acceleration) and steering parameters sp
// (vehicle/controller.py::linear_steering).
struct Law {
  bool linear;
  float th0, th1, th2, sp0, sp1;
};

// LinearVehicle's time headway of its safe distance
#define LINEAR_TIME_WANTED 2.5f

// vehicle/behavior.py::linear_acceleration of ego row e behind row f: the
// unclipped target speed, the front row's scalar speed, dv and dp 0 where
// no front row exists; distance_wanted is IDM's jam distance d0
__device__ __forceinline__ float linear_accel(float distance_wanted, const Law& law,
                                              const Row& e, const Row& f) {
  const float vt = e.target_speed - e.speed;
  const float d_safe = distance_wanted + fmaxf(e.speed, 0.f) * LINEAR_TIME_WANTED;
  const float dv = fminf(f.speed - e.speed, 0.f);
  const float dp = fminf((f.s - e.s) - d_safe, 0.f);
  return (law.th0 * vt + law.th1 * (f.ex ? dv : 0.f)) + law.th2 * (f.ex ? dp : 0.f);
}

// LinearVehicle's steering (vehicle/controller.py::linear_steering) toward a
// lane of heading lane_heading, lat off it, with the parameters sp
__device__ __forceinline__ float linear_steer(float lane_heading, float lat, float heading,
                                              float speed, float len, float sp0, float sp1) {
  const float nz = not_zero(speed);
  const float feat_h = wrap_to_pi(lane_heading - heading) * len / nz;
  const float feat_lat = -lat * len / (nz * nz);
  return clampf(sp0 * feat_h + sp1 * feat_lat, -MAX_STEER_F, MAX_STEER_F);
}

// The free-road term of vehicle/behavior.py::idm_acceleration for ego row
// e, 0 where accel_pair returns 0 without it (a missing row or no vehicle)
// or does not read it (a Linear decider)
__device__ __forceinline__ float free_term(const Params& p, const Geo& g, const Law& law,
                                          float delta, const Row& e) {
  if (!(e.ex && e.vehicle) || law.linear) return 0.f;
  float ts = g.has_limit ? clampf(e.target_speed, 0.f, g.speed_limit)
                         : e.target_speed;
  return p.comfort_acc_max *
         (1.0f - powf(fmaxf(e.speed, 0.f) / fabsf(not_zero(ts)), delta));
}

// idm_acceleration masked as the plain frame's accel(), given e's free-road
// term: a row's term is computed once, however many fronts it meets; the
// decider's linear law where it is Linear
__device__ __forceinline__ float accel_pair(const Params& p, const Law& law, float free_acc,
                                            const Row& e, const Row& f) {
  if (!(e.ex && e.vehicle)) return 0.f;
  if (law.linear) return linear_accel(p.distance_wanted, law, e, f);
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
// thread without a slot (i >= V) keeps these padding values.  ch and sh
// are cosf and sinf of the heading, carried from one frame's stage_post to
// the next frame's frame_start; diag, the diagonal, does not change.
struct Slot {
  float px = 0.f, py = 0.f, heading = 0.f, speed = 0.f, ts = 0.f, timer = 0.f;
  float ix = 0.f, iy = 0.f, steer = 0.f, acc = 0.f, delta = 4.f;
  float len = 5.f, wid = 2.f, gain = 0.f, max_braking = 0.f;
  float ch = 1.f, sh = 0.f, diag = 0.f;
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

  // the carried values of the loaded (or padding) fields
  __device__ void derive() {
    ch = cosf(heading);
    sh = sinf(heading);
    diag = sqrtf(len * len + wid * wid);
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

// A slot of the kernels' Linear rows' instantiation: the slot and, on a
// Linear row, its five parameters, loaded once a launch.
struct LinearSlot : Slot {
  float th0 = 0.f, th1 = 0.f, th2 = 0.f, sp0 = 0.f, sp1 = 0.f;

  __device__ void load(const Fields& f, size_t o) {
    Slot::load(f, o);
    if (kind == KIND_LINEAR) {
      th0 = f.accel_params[3 * o];
      th1 = f.accel_params[3 * o + 1];
      th2 = f.accel_params[3 * o + 2];
      sp0 = f.steer_params[2 * o];
      sp1 = f.steer_params[2 * o + 1];
    }
  }
};

// The slot type of a frame kernel's instantiation
template <bool kLinear>
struct SlotOf {
  using type = Slot;
};
template <>
struct SlotOf<true> {
  using type = LinearSlot;
};

// A slot's laws: IDM's for a Slot (every branch of drive() on the linear
// law folds away), its kind's for a LinearSlot
__device__ __forceinline__ Law law_of(const Slot&) { return {false, 0.f, 0.f, 0.f, 0.f, 0.f}; }
__device__ __forceinline__ Law law_of(const LinearSlot& v) {
  return {v.kind == KIND_LINEAR, v.th0, v.th1, v.th2, v.sp0, v.sp1};
}

// A slot's frame-start row in shared memory, two float4s: the neighbour
// walks read s, the row fetch and the abort scan the rest.
struct __align__(16) StartRow {
  float s, speed, ts, vx;
  float vy, cos, sin;
  int flags;
};

// A slot's post-integration row, three float4s: the sphere pre-check reads
// the first, the SAT all three.  len, wid, orig (the sorted kernel's
// original slot) and obj (the dense kernel's objects instantiation:
// F_SOLID | F_OBSTACLE) do not change and are staged once per launch.
struct __align__(16) PostRow {
  float px, py, speed, diag;
  float cos, sin, vx, vy;
  float len, wid;
  int orig, obj;
};

// A block's rows and ballot words in shared memory: ROW_WORDS per thread
// (its two rows, and its lane and target lane for the abort scan's dense
// fallback) and WARP_WORDS(L) per warp: memb(l), the occupiable slots of
// the warp on lane l (|lat - offset_l| <= width / 2 + 1); abrt(l), its
// controlled slots changing lanes into lane l (the abort scan's
// candidates); and the collision gate's ac (active and collidable slots),
// veh (vehicles) and chk (slots that check collisions), and a word of
// padding that keeps what follows 8-byte aligned.  One base pointer each,
// so the arrays cost few registers.
#define ROW_WORDS 22
#define WARP_WORDS(L) (2 * (L) + 4)
struct Rows {
  PostRow* post;
  StartRow* start;
  int2* lanes;
  unsigned* words;
  int nw, L;

  // carves them for n threads and L lanes from p, which is 16-byte aligned;
  // returns the first word after them
  __device__ float* carve(float* p, int n, int lanes_) {
    nw = n / 32;
    L = lanes_;
    post = reinterpret_cast<PostRow*>(p);
    start = reinterpret_cast<StartRow*>(post + n);
    lanes = reinterpret_cast<int2*>(start + n);
    words = reinterpret_cast<unsigned*>(lanes + n);
    return reinterpret_cast<float*>(words + WARP_WORDS(L) * nw);
  }

  // the same rows with the ballot words' base moved to the env's warp w0:
  // the view through which a block whose first warp is w0 writes its warps'
  // words with ballot_word, which indexes them by threadIdx.x (the global
  // layout, straight_global.cuh, where an env spans several blocks)
  __device__ Rows at_warp(int w0) const {
    Rows v = *this;
    v.words += w0;
    return v;
  }

  __device__ unsigned* memb(int l) const { return words + l * nw; }
  __device__ unsigned* abrt(int l) const { return words + (L + l) * nw; }
  __device__ unsigned* ac() const { return words + 2 * L * nw; }
  __device__ unsigned* veh() const { return words + (2 * L + 1) * nw; }
  __device__ unsigned* chk() const { return words + (2 * L + 2) * nw; }

  __device__ float s(int j) const { return start[j].s; }

  // the frame-start row of slot j, or the all-zero row of a missing
  // neighbour (j < 0)
  __device__ Row fetch(int j) const {
    Row r;
    r.ex = j >= 0;
    if (r.ex) {
      const float4 a = reinterpret_cast<const float4*>(start + j)[0];
      const float4 b = reinterpret_cast<const float4*>(start + j)[1];
      r.s = a.x;
      r.speed = a.y;
      r.target_speed = a.z;
      r.vx = a.w;
      r.vy = b.x;
      r.c = b.y;
      r.sn = b.z;
      r.vehicle = (__float_as_int(b.w) & F_VEHICLE) != 0;
    } else {
      r.speed = r.target_speed = r.s = r.vx = r.vy = r.c = r.sn = 0.f;
      r.vehicle = false;
    }
    return r;
  }

  // px, py, speed and diag of slot j after the integration
  __device__ float4 pose(int j) const { return reinterpret_cast<const float4*>(post + j)[0]; }
};

// The ballot of pred over the calling warp, stored by its lane 0 in
// words[warp]; every thread of the warp calls it.
__device__ __forceinline__ void ballot_word(unsigned* words, bool pred) {
  const unsigned bits = __ballot_sync(FULL_MASK, pred);
  if ((threadIdx.x & 31) == 0) words[threadIdx.x >> 5] = bits;
}

// The bits lo..hi of a word, 0 <= lo, hi <= 31; none where lo > hi.
__device__ __forceinline__ unsigned span_bits(int lo, int hi) {
  return (FULL_MASK >> (31 - hi)) & (FULL_MASK << lo);
}

// Word w of word(w), masked to the slots lo..hi but self.
template <typename Word>
__device__ __forceinline__ unsigned band_word(Word word, int w, int lo, int hi, int self) {
  unsigned bits = word(w) & span_bits(max(lo - (w << 5), 0), min(hi - (w << 5), 31));
  return w == (self >> 5) ? bits & ~(1u << (self & 31)) : bits;
}

// Calls visit(j) for every set bit j of the words word(w) with lo <= j <=
// hi and j != self, in ascending j: the dense pass's column order, so its
// tie rules hold.
template <typename Word, typename Visit>
__device__ __forceinline__ void visit_bits(Word word, int lo, int hi, int self,
                                           Visit visit) {
  for (int w = lo >> 5; w <= (hi >> 5); ++w) {
    for (unsigned bits = band_word(word, w, lo, hi, self); bits; bits &= bits - 1) {
      visit((w << 5) + __ffs(bits) - 1);
    }
  }
}

// One slot's frame-start projection on the road axis.
struct Start {
  float s, lat0, ch, sh, vx, vy;
  bool occ;
};

// Query k of a slot on `lane`: the own lane (k = 0), lane -1 (k = 1) and
// lane +1 (k = 2), the last two clamped to the road.
__device__ __forceinline__ int query_lane(int lane, int k, int L) {
  return k == 0 ? lane : clampi(lane + (k == 1 ? -1 : 1), 0, L - 1);
}

__device__ __forceinline__ Start frame_start(const Slot& v, const Geo& g) {
  Start st;
  st.s = (v.px - g.ox) * g.ux + (v.py - g.oy) * g.uy;
  st.lat0 = (v.px - g.ox) * g.nx + (v.py - g.oy) * g.ny;
  st.ch = v.ch;
  st.sh = v.sh;
  st.vx = v.speed * st.ch;
  st.vy = v.speed * st.sh;
  st.occ = (-VEHICLE_LENGTH <= st.s) && (st.s < g.in_range_hi) && v.active() &&
           v.kind != KIND_LANDMARK;
  return st;
}

// Is slot i a member of lane l (occupiable, |lat - offset_l| <= width / 2 + 1)?
__device__ __forceinline__ bool lane_member(const Start& st, bool live, const Geo& g,
                                            int l) {
  return live && st.occ && fabsf(st.lat0 - lane_offset(l)) <= g.member_tol;
}

// Stages slot i's frame-start row and its bits of the lane and abort
// words; every thread of the block calls it.
__device__ __forceinline__ void stage_start(const Rows& r, int i, bool live, const Slot& v,
                                            const Start& st, const Geo& g) {
  const bool controlled = live && v.is_controlled();
  const int flags =
      live ? ((v.is_vehicle() ? F_VEHICLE : 0) | (controlled ? F_CONTROLLED : 0)) : 0;
  float4* row = reinterpret_cast<float4*>(r.start + i);
  row[0] = make_float4(st.s, v.speed, v.ts, st.vx);
  row[1] = make_float4(st.vy, st.ch, st.sh, __int_as_float(flags));
  r.lanes[i] = make_int2(v.lane, v.tlane);
  for (int l = 0; l < g.n_lanes; ++l) {
    ballot_word(r.memb(l), lane_member(st, live, g, l));
    ballot_word(r.abrt(l), controlled && v.tlane == l && v.lane != l);
  }
}

// Stages slot i's post-integration row and its bits of the collision
// gate's words, and carries cosf / sinf of the new heading into the next
// frame; every thread of the block calls it.
__device__ __forceinline__ void stage_post(const Rows& r, int i, bool live, Slot& v) {
  const float c2 = cosf(v.heading), s2 = sinf(v.heading);
  float4* row = reinterpret_cast<float4*>(r.post + i);
  row[0] = make_float4(v.px, v.py, v.speed, v.diag);
  row[1] = make_float4(c2, s2, v.speed * c2, v.speed * s2);
  v.ch = c2;
  v.sh = s2;
  ballot_word(r.ac(), live && v.active() && v.coll);
  ballot_word(r.veh(), live && v.is_vehicle());
  ballot_word(r.chk(), live && v.chk);
}

// the rows the NPC decision pass drives: uncrashed IDM NPCs, and in the
// Linear rows' instantiation (a LinearSlot) uncrashed Linear NPCs too
__device__ __forceinline__ bool is_idm(const Slot& v) {
  return v.kind == KIND_IDM && !v.crashed;
}
__device__ __forceinline__ bool is_idm(const LinearSlot& v) {
  return (v.kind == KIND_IDM || v.kind == KIND_LINEAR) && !v.crashed;
}

// Everything a frame does to slot i between the neighbour search and the
// collision pass: MOBIL with its timer, abort-on-conflict (over the
// candidates of the abort words), the steering / speed P-cascade with
// dual-lane IDM, bicycle integration and re-localization on the nearest
// lane offset.  front / rear are the neighbours' slots (-1 none) on the own
// lane and lanes -1 / +1; each row is fetched where it is read, which keeps
// the six rows out of the registers.  S: a LinearSlot, whose kind picks its
// laws (a Linear row's are LinearVehicle's), or a Slot, whose laws are
// IDM's and the P-cascade.
template <class S>
__device__ void drive(S& v, const Start& st, const int front[3], const int rear[3],
                      const Rows& r, int i, int V, const Geo& g, const Params& p) {
  const int L = g.n_lanes;
  const int lane = v.lane, tlane = v.tlane;
  const float s = st.s, lat0 = st.lat0, speed = v.speed;
  const bool idm = is_idm(v);
  const Law law = law_of(v);
  const Row self = {speed, v.ts, s, st.vx, st.vy, st.ch, st.sh, true, v.is_vehicle()};
  const float free_self = free_term(p, g, law, v.delta, self);

  // --- MOBIL lane change ----------------------------------------------------
  const Row front0 = r.fetch(front[0]);
  const float a_self = accel_pair(p, law, free_self, self, front0);
  const bool mid_change = lane != tlane;
  const bool deciding = idm && !mid_change && v.timer > p.lane_change_delay && v.elc;
  float new_timer = deciding ? 0.f : v.timer;
  int target = tlane;
  if (deciding) {
    const Row rear0 = r.fetch(rear[0]);
    const float free_rear = free_term(p, g, law, v.delta, rear0);
    const float a_of = accel_pair(p, law, free_rear, rear0, self);
    const float a_of_pred = accel_pair(p, law, free_rear, rear0, front0);
    const bool moving = fabsf(speed) >= 1.0f;
#pragma unroll
    for (int k = 1; k < 3; ++k) {
      const int d = k == 1 ? -1 : 1;
      const bool exists = lane + d >= 0 && lane + d < L;
      const Row rear_k = r.fetch(rear[k]), front_k = r.fetch(front[k]);
      const float free_nf = free_term(p, g, law, v.delta, rear_k);
      const float a_nf = accel_pair(p, law, free_nf, rear_k, front_k);
      const float a_nf_pred = accel_pair(p, law, free_nf, rear_k, self);
      const float a_self_pred = accel_pair(p, law, free_self, self, front_k);
      const bool safe = a_nf_pred >= -v.max_braking;
      const float jerk = (a_self_pred - a_self) +
                         p.politeness * (((a_nf_pred - a_nf) + a_of_pred) - a_of);
      const int q = query_lane(lane, k, L);
      const bool reachable = fabsf(lat0 - lane_offset(q)) <= g.reach_lat &&
                             0.f <= s && s < g.in_range_hi;
      if (exists && reachable && moving && safe && jerk >= v.gain) target = q;
    }
  }
  // abort a lane change into a gap another vehicle is closing
  if (idm && mid_change) {
    auto closing = [&](int j) {
      const StartRow& o = r.start[j];
      const float d_ij = o.s - s;
      const float dv = (st.vx - o.vx) * st.ch + (st.vy - o.vy) * st.sh;
      const float d_star = (p.distance_wanted + speed * p.time_wanted) +
                           (speed * dv) * p.inv_two_sqrt_ab;
      return 0.f < d_ij && d_ij < d_star;
    };
    bool conflict = false;
    if (tlane >= 0 && tlane < L) {
      const unsigned* abrt = r.abrt(tlane);
      visit_bits([&](int w) { return abrt[w]; }, 0, V - 1, i,
                 [&](int j) { conflict = conflict || closing(j); });
    } else {  // a target off the road: no abort word, the dense scan
      for (int j = 0; j < V && !conflict; ++j) {
        if (j == i || !(r.start[j].flags & F_CONTROLLED)) continue;
        if (r.lanes[j].x == tlane || r.lanes[j].y != tlane) continue;
        conflict = closing(j);
      }
    }
    if (conflict) target = lane;
  }

  // --- low-level controls ---------------------------------------------------
  const float lat_t = lat0 - lane_offset(clampi(target, 0, L - 1));
  float steer_pc;
  if (law.linear) {
    steer_pc = linear_steer(g.theta, lat_t, v.heading, speed, v.len, law.sp0, law.sp1);
  } else {
    const float heading_cmd =
        asinf(clampf((-p.kp_lateral * lat_t) / not_zero(speed), -1.f, 1.f));
    const float heading_ref = g.theta + clampf(heading_cmd, -QUARTER_PI_F, QUARTER_PI_F);
    const float rate = p.kp_heading * wrap_to_pi(heading_ref - v.heading);
    const float slip = asinf(clampf(v.len / 2.f / not_zero(speed) * rate, -1.f, 1.f));
    steer_pc = clampf(atan2f(2.f * sinf(slip), cosf(slip)), -MAX_STEER_F, MAX_STEER_F);
  }
  // dual-lane IDM while changing lanes
  const int d_t = target - lane;
  const Row f_t = d_t == 0 ? front0 : r.fetch(d_t < 0 ? front[1] : front[2]);
  const float a_idm = clampf(
      target != lane ? fminf(a_self, accel_pair(p, law, free_self, self, f_t)) : a_self,
      -p.acc_max, p.acc_max);
  // the ego's P-cascade, unless it keeps its raw controls (the TPU
  // kernel's raw_controls branch, straight_pallas_bm.py:902-904)
  const bool is_ego = v.kind == KIND_EGO && !p.raw;
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
    float best_d = fabsf(lat_new - lane_offset(0));
    for (int l = 1; l < L; ++l) {
      const float dl = fabsf(lat_new - lane_offset(l));
      if (dl < best_d) {
        best_d = dl;
        best = l;
      }
    }
    v.lane = best;
  }
  v.timer = new_timer;
}

// A frame kernel's instantiation meets no row it was not built for (the
// general kernels' IDM one no Linear row, GenParams::linear off; the
// straight ones', trap_on_kinds): where its block holds one (bad_row in
// some thread), the caller launched it with the wrong parameters for the
// state, and the launch traps
// (cudaErrorLaunchFailure) before it stores the block's rows, so no row
// comes out stepped by the wrong law.  Every thread of the block calls it,
// once a launch, after the frame loop: there the check leaves the loop's
// registers and spills as they are without it.
__device__ __forceinline__ void trap_on_rows(bool bad_row) {
  if (__syncthreads_or(bad_row)) __trap();
}

// The straight kernels' check: a Linear row without kLinear (Params::linear
// off), an obstacle or landmark row without kObjects (Params::objects off:
// every lean instantiation, the sorted K3 among them); one barrier a
// launch, none where the instantiation takes every kind
template <bool kLinear, bool kObjects>
__device__ __forceinline__ void trap_on_kinds(bool live, int kind) {
  if constexpr (!kLinear || !kObjects) {
    trap_on_rows(live && ((!kLinear && kind == KIND_LINEAR) ||
                          (!kObjects && (kind == KIND_OBSTACLE || kind == KIND_LANDMARK))));
  }
}

// The pair's collision gate of the general frame kernel (road collision
// protocol): both active, one a vehicle, one checking collisions, both
// collidable.
__device__ __forceinline__ bool pair_eligible(int fa, int fb) {
  return (fa & F_ACTIVE) && (fb & F_ACTIVE) && ((fa & F_VEHICLE) || (fb & F_VEHICLE)) &&
         ((fa & F_CHECK) || (fb & F_CHECK)) && (fa & F_COLLIDABLE) && (fb & F_COLLIDABLE);
}

// Slot i's collision candidates in warp word w: the active, collidable
// slots that make an eligible pair with it (one of the two a vehicle, one
// checking collisions); none where slot i is not active and collidable.
__device__ __forceinline__ unsigned gate_word(const Rows& r, int w, bool ac_i, bool veh_i,
                                              bool chk_i) {
  return ac_i ? r.ac()[w] & (veh_i ? FULL_MASK : r.veh()[w]) &
                    (chk_i ? FULL_MASK : r.chk()[w])
              : 0u;
}

// The dense pass's sphere pre-check of the pair (a, b) with poses A and B
// (px, py, speed, diag), its reach with the speed speed_lo.
__device__ __forceinline__ bool within_reach(const float4& A, const float4& B,
                                             float speed_lo, const Params& p) {
  const float dx = A.x - B.x, dy = A.y - B.y;
  const float reach = (A.w + B.w) / 2.f + speed_lo * p.dt;
  return dx * dx + dy * dy <= reach * reach;
}

// The folded swept SAT of the pair (a, b), a the first rectangle.
__device__ __forceinline__ void sat_pair(const Rows& r, const Params& p, int a, int b,
                                         bool* inter, bool* will, float* tx, float* ty) {
  const PostRow& A = r.post[a];
  const PostRow& B = r.post[b];
  sat(A.px, A.py, A.len, A.wid, A.cos, A.sin, B.px, B.py, B.len, B.wid, B.cos, B.sin,
      (A.vx - B.vx) * p.dt, (A.vy - B.vy) * p.dt, inter, will, tx, ty);
}

// The dynamic shared memory of a frame kernel's block at V slots and L
// lanes: the lane offsets, then `words` 4-byte words per thread (one a slot,
// rounded up to a warp) and `warp_words` per warp
// (ops/straight_frames.py::launch_smem computes it alike for make).
__host__ __forceinline__ size_t frames_smem(int V, int L, int words, int warp_words) {
  const int threads = ((V + 31) / 32) * 32;
  return (static_cast<size_t>(lane_offset_words(L)) + static_cast<size_t>(words) * threads +
          static_cast<size_t>(warp_words) * (threads / 32)) *
         sizeof(float);
}

// Launch of a frame kernel with one block per env, one thread per slot
// (rounded up to a warp) and frames_smem of shared memory.  Returns the
// CUDA error code.
template <typename Kernel, typename... Args>
int launch_per_env(Kernel kernel, int B, int V, int L, int words, int warp_words,
                   void* stream, Args... args) {
  const int threads = ((V + 31) / 32) * 32;
  const size_t smem = frames_smem(V, L, words, warp_words);
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
