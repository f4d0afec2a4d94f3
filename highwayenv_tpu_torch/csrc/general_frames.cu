// All frames of one policy step on an analytic-lane road network (straight,
// sine and circular lanes): a group of G threads per env within one warp
// (G = 16 up to 16 slots, else 32), thread i of the group the owner of slot
// i.  Two kernels from one template: K4 (entry general_frames) and K5
// (entry general_frames_regulated), K4's frame plus the regulated road's
// right-of-way pass.
//
// Replaces the TPU kernels highwayenv_tpu/ops/general_pallas_bm.py::
// build_general_frame(regulated=False) (K4) and (regulated=True) (K5)
// (pallas_call at :1474, frame body _frame_body_general :473-1352, the
// regulated block :1158-1351).  Semantics are those of
// ops/general_frames.py::frames_general_plain, its plain torch version (the
// JAX package's BaseEnv._frame): per frame follow_road on the lane graph,
// the ego meta-action on frame 0, the IDM / MOBIL decision pass on the
// projection table of every slot on every lane, the steering / speed
// controls (with GenParams::raw, a ContinuousAction, the TPU kernel's
// raw_controls branch :1005-1007: no meta-action, and the ego keeps the
// steering and acc the wrapper stored before the launch, on K4 and K5
// alike), on K5's tick frames the right-of-way pass of road/regulation.py,
// bicycle integration, heading-aware re-localization and the swept-SAT
// collision pass with obstacles and last-write impacts.  A Linear row (kind
// KIND_LINEAR, the TPU kernel's has_linear branch :505, :737, :786,
// :979-987) decides with LinearVehicle's acceleration in every pair it
// evaluates, its own law and parameters even where the pair's ego is a
// neighbour, and steers by LinearVehicle's law; the law goes by the row's
// kind.  Each entry launches one of two instantiations: with
// GenParams::linear the one whose decision pass reads each row's kind,
// without it the IDM code alone (the parent's registers, so an IDM-only
// scene pays nothing for the branch), which traps where it meets a Linear
// row (trap_on_rows, straight_common.cuh).
// Each entry has a kConnected twin (general_frames_connected,
// general_frames_regulated_connected) for the -v1 / -v2 ids' connected-lane
// neighbour search (vehicle/behavior.py::neighbours_connected): every
// neighbour query also walks the slots on the query lane's successor and
// predecessor lanes, from per-lane candidate tables that only these
// instantiations receive and keep in shared memory.  The TPU kernels have
// no such branch (the JAX package runs those ids on its XLA frames,
// BaseEnv._frame); the plain version with GeneralSpec.connected is held to
// that XLA path on the CPU and this branch to the plain version on the card.
// Each entry has a kDynamical twin (general_frames_dynamical,
// general_frames_regulated_dynamical) for a dynamical ContinuousAction
// (intersection-v1, lane-keeping-v0): after the kinematic integration the
// ego rows take their position, heading and speed from one RK4 step of the
// BicycleVehicle tire-slip model (vehicle/dynamics.py::integrate_dynamic)
// and write their lateral speed and yaw rate, which these instantiations
// alone read and write (DynFields, the kernel's last parameter, which the
// others do not have).  The TPU kernels have no such branch either (the JAX
// package runs those ids on its XLA frames, BaseEnv._frame, whose override
// this follows).  The two flags are independent (the search reads the
// frame-start tables, the override writes the ego's integrated row), and
// the connected entries have their dynamical twins too
// (general_frames_connected_dynamical,
// general_frames_regulated_connected_dynamical: a dynamical action at the
// -v1 / -v2 ids, e.g. racetrack-v1 with a bicycle-model ego), which take
// the candidate tables and then the DynFields.
// Each operation rounds as the op-by-op torch version does on the same card:
// the library is built with -fmad=false and the precise libm functions, and
// every expression keeps the torch version's order of operations.
//
// What bounds it on an H100: the latency of one warp's dependent chain of
// libm calls (atan2f, fmodf, powf, asinf, cosf / sinf) and shared-memory
// loads, not bytes and not issue slots.  A frame projects every slot on
// every lane and re-localizes it there, decides and steers each IDM slot,
// tests every pair of slots for a collision and, on K5's tick frames,
// predicts every vehicle 11 times ahead and tests every pair of vehicles at
// those times.  A clock64() split of the per-slot design (PERF.md) put a
// launch's time at one warp's frame chain times the frames times the waves:
// a thread per slot walked all L lanes (62% of a roundabout-v0 frame) and
// scanned all V slots per neighbour query, and both threads of a pair
// evaluated it.
//
// What the design does about it:
// - More threads than slots.  The work of a frame that is not one slot's
//   own chain is spread over the group's threads.  The projection table and
//   the re-localization go slot-major: slot j's L lanes are split over
//   c = G / V threads (3 at roundabout-v0, 2 at merge-v0, 1 at V = 16 and
//   25), each keeping the slot's position in registers, the lanes taken
//   grouped by kind so that a step's lanes rarely diverge (PERF.md: 5-13%
//   faster than one (lane, slot) item per thread).  K5's route prediction
//   goes as (time, slot) items (V * 11), the pairs of the collision pass and
//   of the right-of-way pass as V (V - 1) / 2 items from a per-block pair
//   table.  The owner keeps its slot in registers and runs what is the
//   slot's alone: follow_road, the meta-action, the MOBIL decision and the
//   controls, the integration.
// - Each pair once, merged without order.  A pair is evaluated on one
//   thread in its (lower, upper) orientation, as the per-slot loops
//   evaluated it on both of its threads, and its outcome is merged through
//   shared memory by integer atomics whose result does not depend on the
//   order of arrival: crash, hit and yield flags by atomicOr of slot bits;
//   the impact's last-write rule as the highest partner bit (row before
//   column: every partner above a slot outranks every partner below it),
//   whose translation the owner then recomputes with the same SAT; the
//   closest lane as the atomicMin of a packed key (the order of the
//   distance, -0 as +0, then the lane index), which is the first minimum of
//   the lane loop: lane 0 wins on a NaN distance, a NaN on a later lane
//   never wins.  No float atomics.
// - Neighbour searches walk bits.  Each lane's bitmask of the slots
//   eligible there is a warp ballot of the projection step, one atomicOr
//   per lane and step (never a lane's V slots on one word at once); a
//   search walks its set bits in ascending slot order with the dense loop's
//   comparisons (front: smallest s >= own, the last slot among ties; rear:
//   largest s < own, the first among ties).  IDM's free-road term (a
//   precise powf) is evaluated once per ego row of a decision.
// - Shared memory per env: the (L, V) tables and the post-integration rows
//   share their words with K5's predictions and route walks, which live
//   only in the right-of-way pass.  A block is GEN_BLOCK = 64 threads.
//   roundabout-v0 (V=5, L=32, R=11): 4 envs a block, 2.6 KB an env,
//   14.8 KB a block; the intersection-v0 warm-up (V=16, L=20, R=3): 4
//   envs, 5.3 KB an env, 24.1 KB a block; intersection-v0 (V=25): 2 envs,
//   8.2 KB an env, 19.8 KB a block (the fixed layout's tables).  Registers (115
//   and 118, PERF.md) then allow 8 blocks, 16 warps, an SM: roundabout-v0's
//   1,024 blocks and the warm-up's 1,024 run in one wave, intersection-v0's
//   2,048 in two.
// - Tables of the scene's size.  The lane tables (an int row of
//   lane_i_words(S, sized) words for S successor edges a lane), the
//   candidate tables of K lanes a lane, the route arrays of R slots a slot
//   and the lanes' order are as wide as the scene asks; the speed grid of
//   n_speeds entries and the poly bank are read from global memory.  A
//   scene within the fixed layout (S <= 4, K <= 9, R <= 16, no poly lane)
//   runs the instantiations without kSized, on tables padded to it (the
//   strides compile-time constants, the code and registers those of the
//   tables before they were sized); any other the kSized instantiation,
//   built into libraries of their own (general_frames_sized.cu and its
//   wide and cluster twins: the same entries, Linear rows always
//   possible).  The one limit besides the slots is the shared memory a
//   block asks (launch_smem), at most the card's opt-in maximum (227 KB on
//   an H100), which make refuses past with a copy of the formula
//   (ops/general_frames.py::launch_smem).
// - Poly lanes (road/lane.py's POLY kind, PolyLaneFixedWidth and PolyLane):
//   a fourth kind in local_coords, lane_position and lane_heading over the
//   bank of 1 m pose samples and control points (PolyBank, global memory,
//   read-only), projected by a backward scan that stops at the first pose
//   the point projects forward on (the reference's last such pose), taken
//   last in the lanes' order by kind.  The frame reads a lane's table width
//   where the JAX package's _frame does (eligibility, reachability); no
//   step of the frame reads a PolyLane's width at s.
// Every exchange between an env's threads goes through shared memory or a
// warp vote at points every thread of the warp reaches (the warp barrier
// group_sync between phases), whatever its env does.
//
// The wide branch (general_frames_wide_kernel, built from
// general_frames_wide.cu into a library of its own with the same entry
// names): scenes of 33 to GEN_WIDE_SLOTS = 128 slots (intersection-v0 at
// longer durations, exit-v0 at highway density, a crowded racetrack), which
// the TPU kernels leave to the JAX package's XLA frames (its Pallas gate,
// general_pallas_bm.py:190, takes V <= 32).  The same frame body, with one
// env a block of GEN_WIDE_BLOCK = 128 threads, slot t on thread t and the
// spare threads sharing the projection table and the pair passes as in the
// narrow design; the barrier is the block's; every slot mask (a lane's
// eligible slots, a slot's impact partners, the crash / hit / yield bits)
// is W = GEN_WIDE_WORDS words, slot s at bit s % 32 of word s / 32, set by
// one atomicOr a bit (a lane's eligible slots are few); the neighbour
// searches walk the words in ascending order, so the tie rules hold as in
// one word, and the impact takes the highest partner bit from the top word
// down.  Shared memory a block: intersection-v0 with duration 30 (V=42,
// L=20, R=3) 18.6 KB, with duration 116 (V=128) 61.0 KB; over 48 KB only
// through cudaFuncSetAttribute, set once per kernel and card (launch).  Registers (96 to 128 a thread) allow 4 to 5
// blocks an SM: B=4096 runs in 7 to 8 waves.
//
// The cluster branch (general_frames_cluster_kernel, built from
// general_frames_cluster.cu into a third library with the same entry
// names): scenes of 129 to GEN_CLUSTER_SLOTS = 2048 slots (intersection at
// the simulator's decision rate, exit-v0 and racetrack-v0 with 150 to 2047
// vehicles), which one block cannot hold: the pair table packs a slot in a
// byte, and one env's arrays grow as L V (intersection at V = 300 would
// take ~310 KB).  The same frame body, with one env a thread-block cluster
// of N = ceil(V / 128) blocks (2 to 16) of 128 threads, slot j owned by
// thread j % 128 of rank j / 128.  Each rank keeps the lane tables and, for
// its own slots only, the projection-table columns, the frame-start and
// post-integration rows, the route arrays and K5's predictions, at the same
// offsets in every rank (a stride of 128 slots), so that the slot's own
// chain (follow_road, the meta-action, MOBIL, the controls, the
// integration, the closest lane's 64-bit key) stays in its block.  What
// reads another slot (the neighbour walks, the abort test, the collision
// and right-of-way pairs, the impact's SAT) reads its owner's shared memory
// through cooperative_groups::cluster_group::map_shared_rank (slot_ref).
// A slot mask keeps word w on rank w / 4; a pair's outcome sets the
// partner's bit with an atomicOr on the partner's rank (crash, hit,
// yield), and the impact keeps the highest partner as an atomicMax of
// partner + 1 in the slot's first imp word, which is the same partner as
// the highest bit.  The neighbour walks visit the ranks in ascending order,
// so the tie rules hold as in one block.  There is no pair table: the
// V (V - 1) / 2 pairs are enumerated over the N 128 threads of the cluster
// (for_pairs_counted).  The barrier is cluster.sync(), which every thread
// of every block reaches, and a last one keeps every block alive until no
// rank reads its shared memory.  Shared memory a block, the same at any V:
// intersection-v0 (L=20, R=3) 45.1 KB.  Up to 8 blocks (V = 1024) is the
// portable cluster size; 9 to 16 blocks (V up to 2048) only with
// cudaFuncAttributeNonPortableClusterSizeAllowed, which launch sets once
// per kernel and card before it asks cudaOccupancyMaxActiveClusters (once
// per shape) and returns an error where no such cluster fits the card
// (general_cluster_fit, tools/cluster_fit.py, asks the same question).
//
// The global branch (general_frames_global_kernel, built from
// general_frames_global.cu into a library of its own with the same entry
// names, the kSized instantiations alone): the scenes that no layout with
// shared memory holds, past a block's 227 KB (exit-v0 with 100 lanes and
// 100 vehicles asks 315,840 bytes of the wide block) or past
// GEN_CLUSTER_SLOTS, up to GEN_GLOBAL_SLOTS = 8192 (exit-v0 with 2048 to
// 8191 vehicles, intersection at the simulator's decision rate past 135
// s).  The cluster branch's frame body with its arrays in global memory:
// one env a cluster of N blocks (at most 16) of RS threads, RS the fewest
// of 128, 256 and 512 with N RS >= V (global_threads), slot j on thread
// j % RS of rank j / RS.  The env's per-slot arrays are a slab the wrapper
// allocates, cut into chunks of GEN_WIDE_SLOTS = 128 slots, each laid out
// as one cluster block's shared memory is (EnvSmem at V = 128, W = 4), so
// that the cluster branch's strides, slot masks and walks hold unchanged:
// slot j's arrays lie in chunk j / 128, which slot_ref reaches at an
// offset into the slab (peer, Chunks) where the cluster branch maps
// another rank's shared memory.  A block of RS threads owns RS / 128
// chunks; the phases that go over a chunk's words (clearing the masks, the
// projection table) take the chunk's 128 threads, K5's predictions go
// slot by slot on the owners.  The lane tables, the candidate tables and
// the lanes' order by kind (the wrapper's table) stay in global memory:
// nothing of a block grows with L or V, so no scene is over a block's
// limit.  The barrier is cluster.sync(), whose arrive / wait are release /
// acquire at cluster scope, so a slab word one block writes is seen by
// every block of the cluster after it; the slab is never read through the
// non-coherent path.  The pair and item loops, the atomics and the
// impact's atomicMax are the cluster branch's, on global words.  Registers
// are capped at 128 a thread by __launch_bounds__(512), so that 16 blocks
// of 512 threads fit 16 SMs.

#include <cooperative_groups.h>
#include <string.h>

#include "straight_common.cuh"

namespace cg = cooperative_groups;

#define GEN_MAX_SLOTS 32  // the narrow kernels: an env's group within one warp
#define GEN_WIDE_SLOTS 128  // the wide kernels: one env a block
#define GEN_WIDE_BLOCK 128  // threads a block of the wide kernels, one a slot
#define GEN_WIDE_WORDS (GEN_WIDE_SLOTS / 32)  // words of a wide slot mask
// the cluster kernels: one env a cluster of up to 16 blocks of
// GEN_WIDE_SLOTS slots each (over GEN_PORTABLE_CLUSTER blocks, the
// portable cluster size, through the non-portable size attribute)
#define GEN_CLUSTER_BLOCKS 16
#define GEN_PORTABLE_CLUSTER 8
#define GEN_CLUSTER_SLOTS (GEN_CLUSTER_BLOCKS * GEN_WIDE_SLOTS)
// the global kernels: one env a cluster of up to 16 blocks of up to 512
// threads, its arrays in global memory
#define GEN_GLOBAL_THREADS 512
#define GEN_GLOBAL_SLOTS (GEN_CLUSTER_BLOCKS * GEN_GLOBAL_THREADS)
#define GEN_BLOCK 64  // threads a block of the narrow kernels
#define LANE_STRAIGHT 0
#define LANE_SINE 1
#define LANE_CIRCULAR 2
#define LANE_POLY 3  // a lane of 1 m pose samples in the poly bank (PolyBank)
// The fixed layout of the tables, which the instantiations without kSized
// read at compile-time strides: 4 successor edges a lane, 9 candidate lanes
// a lane under the connected-lane search (the tables padded to them)
#define GEN_FIXED_SUCC 4
#define GEN_FIXED_CONN 9
#define GEN_FIXED_ROUTE 16  // and at most 16 route slots (a mask's bits)
#define GEN_FIXED_SPEEDS 16  // and at most 16 target speeds, in GenParams
#define HALF_PI_F 1.57079632679489661923f
// road/regulation.py: the prediction times CONFLICT_STEP .. 2.75 s and the
// yield duration in ticks, YIELD_DURATION * REGULATION_FREQUENCY
#define REG_TIMES 11
#define REG_STEP 0.25f
#define REG_YIELD_TICKS 0.0f

// The barrier between the phases of a frame: an env's threads are one
// group of one warp (narrow), one block (kWide) or one cluster (kCluster),
// and every thread of the warp, the block or the cluster reaches it.
template <bool kWide, bool kCluster>
__device__ __forceinline__ void group_sync() {
  if constexpr (kCluster)
    cg::this_cluster().sync();
  else if constexpr (kWide)
    __syncthreads();
  else
    __syncwarp();
}

// The blocks of this block's cluster and its rank there (one block of
// rank 0 outside kCluster).
template <bool kCluster>
__device__ __forceinline__ int cluster_blocks() {
  if constexpr (kCluster)
    return static_cast<int>(cg::this_cluster().num_blocks());
  else
    return 1;
}
template <bool kCluster>
__device__ __forceinline__ int cluster_rank() {
  if constexpr (kCluster)
    return static_cast<int>(cg::this_cluster().block_rank());
  else
    return 0;
}

// The global layout's chunks of an env's slab (kGlobal): `bytes` apart,
// this thread's slot in chunk `chunk`; unread by the other layouts.
struct Chunks {
  ptrdiff_t bytes = 0;
  int chunk = 0;
};

// Rank r's copy of the shared array a: under kGlobal chunk r's array in
// the env's slab (a lies in chunk c.chunk), under kCluster a pointer into
// rank r's shared memory at a's offset (distributed shared memory), else a.
template <bool kCluster, bool kGlobal, typename T>
__device__ __forceinline__ T* peer(const Chunks& c, T* a, int r) {
  if constexpr (kGlobal)
    return reinterpret_cast<T*>(reinterpret_cast<char*>(a) +
                                static_cast<ptrdiff_t>(r - c.chunk) * c.bytes);
  else if constexpr (kCluster)
    return cg::this_cluster().map_shared_rank(a, r);
  else
    return a;
}

// Slot j's element of an env's per-slot array a: a[j], or under kCluster
// element j % GEN_WIDE_SLOTS of the copy on j's owner, rank (kGlobal:
// chunk) j / GEN_WIDE_SLOTS.
template <bool kCluster, bool kGlobal, typename T>
__device__ __forceinline__ T& slot_ref(const Chunks& c, T* a, int j) {
  if constexpr (kCluster)
    return *peer<true, kGlobal>(c, a + j % GEN_WIDE_SLOTS, j / GEN_WIDE_SLOTS);
  else
    return a[j];
}

// Slot s in a slot mask of W words: word s / 32, bit s % 32 (one word
// where W is 1, as the narrow kernels hold at most 32 slots).
template <int W>
__device__ __forceinline__ int word_of(int s) {
  return W == 1 ? 0 : s >> 5;
}
template <int W>
__device__ __forceinline__ unsigned bit_of(int s) {
  return 1u << (W == 1 ? s : s & 31);
}
template <int W>
__device__ __forceinline__ bool has_slot(const unsigned* m, int s) {
  return (m[word_of<W>(s)] & bit_of<W>(s)) != 0u;
}
// Sets slot s in the slot mask m of an env: under kCluster in the words of
// s's owner, which keeps the W words of its own slots.
template <bool kCluster, bool kGlobal, int W>
__device__ __forceinline__ void set_slot(const Chunks& c, unsigned* m, int s) {
  if constexpr (kCluster)
    atomicOr(peer<true, kGlobal>(c, m + word_of<W>(s % GEN_WIDE_SLOTS), s / GEN_WIDE_SLOTS),
             bit_of<W>(s));
  else
    atomicOr(&m[word_of<W>(s)], bit_of<W>(s));
}

// the post-integration rows' flag bits are straight_common.cuh's (F_ACTIVE,
// F_VEHICLE, F_CHECK, F_COLLIDABLE, F_SOLID, F_OBSTACLE)

// columns of the lane tables (ops/general_frames.py::lane_tables)
enum {
  LF_SX, LF_SY, LF_UX, LF_UY, LF_NX, LF_NY, LF_H0, LF_AMP, LF_PULS, LF_PHASE,
  LF_CX, LF_CY, LF_RAD, LF_SP, LF_CW, LF_WIDTH, LF_LEN, LF_LIMIT, LANE_F_WORDS
};
// The int table's row of a lane: the fixed columns, the S successor edges'
// base lanes (-1 pad) and their lane counts, the priority, and in the kSized
// layout the lane's row of the poly bank (-1 on an analytic lane): a row of
// lane_i_words(S, kSized) words, 16 in the fixed layout (S = 4).
enum {
  LI_KIND, LI_FORBIDDEN, LI_LANE_ID, LI_EDGE_BASE, LI_EDGE_N, LI_FROM, LI_TO,
  LI_SUCC  // succ_base[S], succ_n[S], priority[, poly]
};
__host__ __device__ __forceinline__ int lane_i_words(int S, bool poly) {
  return LI_SUCC + 2 * S + 1 + (poly ? 1 : 0);
}

// The poly lanes' sample bank (road/lane.py::PolyBank, built by
// road/network.py), read-only in global memory: bank row b holds n[b]
// 1 m pose samples (x, y) and unit tangents at [b * S + k] (S a row) and
// cp_n[b] control points, their arc lengths, x and y at cp[(3 b + c) * C +
// k] (C a row, padded as the bank pads them).  Null on a network without
// poly lanes, which no lane then reads.
struct PolyBank {
  const float2* pos;
  const float2* normal;
  const int* n;
  const float* cp;
  const int* cp_n;
  int S, C;
};

struct GenParams {  // ops/general_frames.py::GenParams
  int L, M, V, R, frames, n_speeds, longitudinal, lateral, period;
  int raw;  // 1: egos keep their stored controls; no slot actions, n_speeds 0
  float dt, acc_max, comfort_acc_max, distance_wanted, time_wanted;
  float inv_two_sqrt_ab, politeness, lane_change_delay;
  float kp_a, kp_heading, kp_lateral, tau_pursuit, ts_lo, inv_ts_range;
  float target_speeds[GEN_FIXED_SPEEDS];  // the fixed layout's speed grid
  int linear;  // 1: Linear rows possible (the Linear rows' instantiation)
  int S;       // successor edges a lane: the int lane table's row is lane_i_words(S, sized)
  int K;       // kConnected: candidate lanes a lane, the candidate tables' row
  const float* speed_grid;  // kSized: the n_speeds speed grid on the device (null under raw)
  PolyBank poly;
};
static_assert(sizeof(GenParams) == 232,
              "GenParams: 10 ints, 14 floats, the fixed speed grid, linear, S, K, the kSized "
              "speed grid's pointer and the bank, as ops/general_frames.py::GenParams");

// The (B, V[, ...]) tensors, in the order of ops/general_frames.py::
// _IN_FIELDS, then the slot actions, then OUT_FIELDS.
#define N_IN 30
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
  const float* accel_params;  // (B, V, 3), read on Linear rows only
  const float* steer_params;  // (B, V, 2), read on Linear rows only
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

// The kDynamical instantiations' further (B, V) tensors (ops/general_frames.py::
// DYN_FIELDS) in and out, and the float32 factors of
// vehicle/dynamics.py::kernel_constants.
struct DynFields {
  const float* lateral_speed;
  const float* yaw_rate;
  float* lateral_speed_out;
  float* yaw_rate_out;
  float dt_half, dt_sixth;  // float32(dt / 2) and float32(dt / 6), as torch rounds them
  float damp;               // float32(INERTIA_Z / LENGTH_A): the low-speed damping
  float inv_inertia;        // float32(1 / INERTIA_Z), the reciprocal torch divides by
};
static_assert(sizeof(DynFields) == 4 * sizeof(void*) + 4 * sizeof(float),
              "DynFields: four pointers and four floats, as ops/general_frames.py::DynFields");

// torch.clamp with scalar bounds: a NaN stays NaN
__device__ __forceinline__ float clamp_keep_nan(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// vehicle/dynamics.py::_derivative of the state s = (x, y, psi, v, v_lat, r)
// at (steer, acc) into k, in torch's order of operations with the model's
// constants: LENGTH_A = LENGTH_B = 2.5, 2 * FRICTION = 30, MASS = 1 (a
// product or quotient by it is exact), and the quotient by INERTIA_Z, a
// Python scalar, a product with its reciprocal as torch on the card takes it
// (in double, rounded to float32).
__device__ __forceinline__ void bicycle_derivative(const float* s, float steer, float acc,
                                                   const DynFields& d, float* k) {
  const float v = s[3], vl = s[4], r = s[5];
  const float theta_vf = atan2f(vl + 2.5f * r, v);
  const float theta_vr = atan2f(vl - 2.5f * r, v);
  float f_yf = 30.0f * (steer - theta_vf);
  float f_yr = 30.0f * (0.0f - theta_vr);
  if (fabsf(v) < 1.0f) {  // the low-speed damping branch
    f_yf = -vl - d.damp * r;
    f_yr = -vl + d.damp * r;
  }
  const float c = cosf(s[2]), sn = sinf(s[2]);
  k[0] = c * v - sn * vl;
  k[1] = sn * v + c * vl;
  k[2] = r;
  k[3] = acc;
  k[4] = (f_yf + f_yr) - r * v;
  k[5] = (2.5f * f_yf - 2.5f * f_yr) * d.inv_inertia;
}

// vehicle/dynamics.py::integrate_dynamic on one row: s, the pre-integration
// (x, y, psi, v, v_lat, r) with r clipped, takes one RK4 step of dt at the
// clipped actions; the stage sum accumulates as torch evaluates
// f1 + 2 * f2 + 2 * f3 + f4, left to right.
__device__ void bicycle_rk4(float* s, float steer, float acc, float dt, const DynFields& d) {
  float k[6], st[6], sum[6];
  bicycle_derivative(s, steer, acc, d, k);
  for (int c = 0; c < 6; ++c) {
    sum[c] = k[c];
    st[c] = s[c] + k[c] * d.dt_half;
  }
  bicycle_derivative(st, steer, acc, d, k);
  for (int c = 0; c < 6; ++c) {
    sum[c] = sum[c] + 2.0f * k[c];
    st[c] = s[c] + k[c] * d.dt_half;
  }
  bicycle_derivative(st, steer, acc, d, k);
  for (int c = 0; c < 6; ++c) {
    sum[c] = sum[c] + 2.0f * k[c];
    st[c] = s[c] + k[c] * dt;
  }
  bicycle_derivative(st, steer, acc, d, k);
  for (int c = 0; c < 6; ++c) s[c] = s[c] + d.dt_sixth * (sum[c] + k[c]);
}

// The lane tables in shared memory (an int row of lane_i_words(S) words),
// and the poly bank in global memory.  kSized: S read at run time and poly
// lanes possible; else the fixed layout's S = GEN_FIXED_SUCC at compile time
// and no lane of kind LANE_POLY (the lane functions drop that branch).
template <bool kSized>
struct Lanes {
  static constexpr bool kPoly = kSized;
  const float* f;
  const int* i;
  int L, S_;
  const PolyBank* poly;
  __device__ int S() const { return kSized ? S_ : GEN_FIXED_SUCC; }
  __device__ float F(int l, int k) const { return f[l * LANE_F_WORDS + k]; }
  __device__ int I(int l, int k) const { return i[l * lane_i_words(S(), kSized) + k]; }
  __device__ int clip(int l) const { return clampi(l, 0, L - 1); }
  // successor edge k < S of lane l: its base lane (-1: none) and lane count
  __device__ int succ_base(int l, int k) const { return I(l, LI_SUCC + k); }
  __device__ int succ_n(int l, int k) const { return I(l, LI_SUCC + S() + k); }
  __device__ int priority(int l) const { return I(l, LI_SUCC + 2 * S()); }
  __device__ int poly_row(int l) const { return I(l, LI_SUCC + 2 * S() + 1); }
};

// road/lane.py::_floor_index: the 1 m sample that s lies on, clipped to
// [0, n - 1] (the float's conversion as torch's .to(int32) on the card)
__device__ __forceinline__ int poly_sample(float s, int n) {
  return min(max(static_cast<int>(floorf(s)), 0), n - 1);
}

// road/lane.py::_poly_frenet on bank row b: the last pose k >= 1 whose
// tangent the point projects on with a non-negative proj wins (a backward
// scan stops at the first), pose 0 the fallback; s = k + proj.  Inlined: a
// call's saved registers spilled more in the cluster kernels (PERF.md).
__device__ __forceinline__ void poly_local(const PolyBank& pb, int b, float px, float py,
                                        float* s, float* lat) {
  const float2* pos = pb.pos + static_cast<size_t>(b) * pb.S;
  const float2* nrm = pb.normal + static_cast<size_t>(b) * pb.S;
  float dx = 0.f, dy = 0.f, proj = 0.f;
  int k = pb.n[b] - 1;
  for (; k >= 1; --k) {
    dx = px - pos[k].x;
    dy = py - pos[k].y;
    proj = nrm[k].x * dx + nrm[k].y * dy;
    if (proj >= 0.f) break;
  }
  if (k < 1) {  // no pose k >= 1 qualifies: pose 0
    k = 0;
    dx = px - pos[0].x;
    dy = py - pos[0].y;
    proj = nrm[0].x * dx + nrm[0].y * dy;
  }
  *s = static_cast<float>(k) + proj;
  *lat = -nrm[k].y * dx + nrm[k].x * dy;
}

// road/lane.py::_poly_segment_normal: the unit tangent of the pose
// segment s lies on, on bank row b
__device__ __forceinline__ float2 poly_normal(const PolyBank& pb, int b, float s) {
  return pb.normal[static_cast<size_t>(b) * pb.S + poly_sample(s, pb.n[b])];
}

// road/lane.py::position on poly bank row b: the control points'
// interpolation (_poly_interp: linear between them, extrapolated past
// either end) plus lat along the segment's normal.
__device__ __forceinline__ void poly_position(const PolyBank& pb, int b, float s, float lat,
                                           float* x, float* y) {
  const float* cs = pb.cp + static_cast<size_t>(3 * b) * pb.C;
  const float* cx = cs + pb.C;
  const float* cy = cx + pb.C;
  const int n = pb.cp_n[b];
  int count = 0;
  for (int c = 0; c < n; ++c) count += cs[c] <= s;
  const int k = min(max(count - 1, 0), max(n - 2, 0));
  const float s0 = cs[k], s1 = cs[k + 1];
  const float t = (s - s0) / (s1 == s0 ? 1.0f : s1 - s0);
  const float2 nr = poly_normal(pb, b, s);
  *x = (cx[k] + t * (cx[k + 1] - cx[k])) - nr.y * lat;
  *y = (cy[k] + t * (cy[k + 1] - cy[k])) + nr.x * lat;
}

// road/lane.py::_local_core on lane l (a clipped index); a poly lane's
// _poly_frenet
template <class LanesT>
__device__ void local_coords(const LanesT& g, int l, float px, float py, float* s, float* lat) {
  const int kind = g.I(l, LI_KIND);
  if constexpr (LanesT::kPoly) {
    if (kind == LANE_POLY) {
      poly_local(*g.poly, g.poly_row(l), px, py, s, lat);
      return;
    }
  }
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
template <class LanesT>
__device__ void lane_position(const LanesT& g, int l, float s, float lat, float* x, float* y) {
  const int kind = g.I(l, LI_KIND);
  if constexpr (LanesT::kPoly) {
    if (kind == LANE_POLY) {
      poly_position(*g.poly, g.poly_row(l), s, lat, x, y);
      return;
    }
  }
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
template <class LanesT>
__device__ float lane_heading(const LanesT& g, int l, float s) {
  const int kind = g.I(l, LI_KIND);
  if constexpr (LanesT::kPoly) {
    if (kind == LANE_POLY) {
      const float2 nr = poly_normal(*g.poly, g.poly_row(l), s);
      return atan2f(nr.y, nr.x);
    }
  }
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
// distance to it (inf for an empty edge).  The loop keeps the distance of
// the lane it will return (the explicit one on an edge as wide as lt's, else
// its first minimum) rather than every lane's, so no array bounds the lanes
// an edge (M <= L).
template <class LanesT>
__device__ int lane_on_edge(const LanesT& g, int lt, int base, int n, int next_id,
                            float px, float py, int M, float* dist) {
  const bool same_width = g.I(lt, LI_EDGE_N) == n;
  const int lane_max = max(n - 1, 0);
  const int wanted = min(max(next_id >= 0 ? next_id : g.I(lt, LI_LANE_ID), 0), lane_max);
  const int wanted_m = min(wanted, M - 1);
  float best = INFINITY, d_closest = INFINITY, d_wanted = INFINITY;
  int closest = 0;
  for (int m = 0; m < M; ++m) {
    float dm = INFINITY;
    if (m < n) {
      const int l = g.clip(base + m);
      float s, lat;
      local_coords(g, l, px, py, &s, &lat);
      dm = fabsf(lat) + fmaxf(s - g.F(l, LF_LEN), 0.f) + fmaxf(-s, 0.f);
    }
    if (m == 0) d_closest = dm;  // the first minimum starts at lane 0
    if (m == wanted_m) d_wanted = dm;
    if (dm < best) {  // first minimum
      best = dm;
      closest = m;
      d_closest = dm;
    }
  }
  // a first minimum lies below n (or is lane 0), so clipping keeps it
  *dist = same_width ? d_wanted : d_closest;
  return base + (same_width ? wanted : min(closest, lane_max));
}

// The closest lane's key: the order of the distance dl (-0 as +0) above the
// lane index, so that the smallest key is the loop's first minimum over
// `l == 0 || dl < best`.  A NaN distance on lane 0 keeps lane 0 whatever
// follows (key 0); a NaN on a later lane is never taken (the largest key).
__device__ __forceinline__ unsigned long long lane_key(float dl, int l) {
  if (dl != dl) return l == 0 ? 0ull : ~0ull;
  const unsigned b = __float_as_uint(dl + 0.f);
  const unsigned order = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(order) << 32) | static_cast<unsigned>(l);
}

// One env's arrays in shared memory.  The projection tables S[l * V + j] and
// LAT[l * V + j] of slot j on lane l and the post-integration rows share
// their words with K5's right-of-way arrays: the predictions (px / py / pc /
// ps [t * V + j]), written after the decision pass last reads S / LAT and
// read before the integration writes the rows, and past them the route
// walks, written from S (never on it).
struct EnvSmem {
  unsigned long long* key;  // the closest lane's packed key, per slot
  float *S, *LAT;
  // post-integration rows
  float *px, *py, *pspeed, *pcos, *psin, *pvx, *pvy, *phead;
  int* pflags;
  // K5's predictions, on the words above
  float *qx, *qy, *qc, *qs;
  // rows that do not change in a step
  float *len, *wid, *diag;
  // frame-start rows (after follow_road and the meta-action)
  float *speed, *ts, *cos, *sin, *vx, *vy;
  int *lane, *tlane, *flags;
  // route arrays, slot-major: [j * R + r]
  int *rbase, *rn, *rid;
  // slot masks of W words (word_of / bit_of)
  unsigned* elig;  // per lane [l * W + w], the slots eligible there (frame-start table)
  unsigned* imp;   // per slot [j * W + w], the partners whose impact it takes
  unsigned* bits;  // the env's crash, hit and yield slot masks, [k * W + w]
  // K5, on the union's words: per slot the route walk's start, frame-start
  // position, priority, first / last segment and valid segments (a mask,
  // the fixed layout's; the valid segments are a run), and per segment the
  // cumulative length and the lane
  float *rs0, *fx, *fy, *rcum;
  int *prio, *rfirst, *rlast, *rvalid, *rseg;
  // kGlobal: where the env's other chunks lie (peer)
  Chunks chunks;

  __host__ __device__ static int union_words(int L, int V, int R, bool reg) {
    const int rows = 2 * L * V + 9 * V;
    return reg ? max(rows, 4 * REG_TIMES * V + 7 * V + 2 * R * V) : rows;
  }
  // W: words of a slot mask (1 in the narrow kernels)
  __host__ __device__ static int words(int L, int V, int R, bool reg, int W) {
    const int w = 2 * V + union_words(L, V, R, reg) + 12 * V + 3 * R * V + W * (L + V + 4);
    return (w + 1) & ~1;  // keeps the next env's keys 8-byte aligned
  }

  __device__ void carve(float* p, int L, int V, int R, bool reg, int W) {
    key = reinterpret_cast<unsigned long long*>(p);
    float* u = p + 2 * V;
    S = u;
    LAT = S + L * V;
    float* q = LAT + L * V;
    float** rows[] = {&px, &py, &pspeed, &pcos, &psin, &pvx, &pvy, &phead};
    for (float** a : rows) {
      *a = q;
      q += V;
    }
    pflags = reinterpret_cast<int*>(q);
    qx = u;
    qy = qx + REG_TIMES * V;
    qc = qy + REG_TIMES * V;
    qs = qc + REG_TIMES * V;
    if (reg) {  // past the predictions: never on S, which the pass reads first
      q = qs + REG_TIMES * V;
      float** rf[] = {&rs0, &fx, &fy};
      for (float** a : rf) {
        *a = q;
        q += V;
      }
      int** ri[] = {&prio, &rfirst, &rlast, &rvalid};
      for (int** a : ri) {
        *a = reinterpret_cast<int*>(q);
        q += V;
      }
      rcum = q;
      rseg = reinterpret_cast<int*>(rcum + R * V);
    }
    q = u + union_words(L, V, R, reg);
    float** fs[] = {&len, &wid, &diag, &speed, &ts, &cos, &sin, &vx, &vy};
    for (float** a : fs) {
      *a = q;
      q += V;
    }
    int** is[] = {&lane, &tlane, &flags};
    for (int** a : is) {
      *a = reinterpret_cast<int*>(q);
      q += V;
    }
    rbase = reinterpret_cast<int*>(q);
    rn = rbase + R * V;
    rid = rn + R * V;
    elig = reinterpret_cast<unsigned*>(rid + R * V);
    imp = elig + L * W;
    bits = imp + V * W;
  }
};

// The words of a block's shared memory before its envs' arrays: the lane
// tables (an int row of lane_i_words(S, sized) words), the lanes' order by kind,
// under the connected-lane search the K candidate lanes and offsets of
// every lane, and the pair table of V slots (none at V = 0, as the cluster
// kernels take it), rounded up to an even count so that each env's keys are
// 8-byte aligned.
__host__ __device__ static int block_words(int L, int V, int S, int K, bool sized) {
  const int w = L * (LANE_F_WORDS + lane_i_words(S, sized) + 1) + 2 * L * K +
                (V * (V - 1) / 2 + 1) / 2;
  return (w + 1) & ~1;
}

// frame-start row flags
#define FS_OCCUPIES 1  // active and not a landmark: may be a neighbour
#define FS_VEHICLE 2
#define FS_CONTROLLED 4

// W: words of a slot mask (of a rank's own slots under kCluster, of a
// chunk's under kGlobal); kSized: the candidate tables' row K read at run
// time, else GEN_FIXED_CONN
template <bool kLinear, bool kConnected, int W, bool kCluster, bool kGlobal, bool kSized>
struct Ctx {
  const Lanes<kSized>& g;
  const GenParams& p;
  const EnvSmem& e;
  int V, i;     // the env's slots, the deciding slot
  float delta;  // the deciding slot's IDM exponent
  Law law;      // the deciding slot's acceleration law, read where kLinear
  // kConnected: each lane's K candidate lanes (-1 pad) and the offsets that
  // shift a candidate's s into the lane's frame
  const int* conn_l;
  const float* conn_f;
  int K_;
  __device__ __forceinline__ int K() const { return kSized ? K_ : GEN_FIXED_CONN; }

  // slot j's element of the per-slot array a, on j's owner under kCluster
  template <typename T>
  __device__ __forceinline__ T& at(T* a, int j) const {
    return slot_ref<kCluster, kGlobal>(e.chunks, a, j);
  }
  // slot j's s on lane l (a clipped index)
  __device__ __forceinline__ float s_on(int l, int j) const {
    return at(e.S + l * (kCluster ? GEN_WIDE_SLOTS : V), j);
  }

  // vehicle/behavior.py::neighbours of slot i on query lane q: front =
  // smallest s >= own s, the last slot among ties; rear = largest s < own s,
  // the first among ties; -1 = none.  The walk visits the eligible slots in
  // ascending order, as the dense loop over every slot did, word after word.
  // kConnected: vehicle/behavior.py::neighbours_connected.  The candidate
  // lanes of q in column order; a slot counts on the first candidate whose
  // eligibility bit it has (the bits already seen are masked off), with its
  // s there plus the candidate's offset as its key (one float add, as the
  // plain s + offset).  The slots no longer come in ascending order, so the
  // tie rules are explicit: the front keeps the highest slot among equal
  // keys, the rear the lowest.  kCluster: the same walk over each rank's
  // eligibility words and S columns in turn, rank 0 first, so the slots
  // still come in ascending order and a slot's first candidate lane is found
  // within its owner's words.  kGlobal: the same walk over the env's chunks.
  __device__ void neighbours(int q, int* front, int* rear) const {
    const int VS = kCluster ? GEN_WIDE_SLOTS : V;  // the tables' stride
    const int l = g.clip(q);
    const float s_self = e.S[l * VS + (kCluster ? i % GEN_WIDE_SLOTS : i)];
    float f_key = INFINITY, r_key = -INFINITY;
    int f = -1, r = -1;
    for (int rk = 0;
         rk < (kGlobal ? (V + GEN_WIDE_SLOTS - 1) / GEN_WIDE_SLOTS : cluster_blocks<kCluster>());
         ++rk) {
      const unsigned* elig = peer<kCluster, kGlobal>(e.chunks, e.elig, rk);
      const float* S = peer<kCluster, kGlobal>(e.chunks, e.S, rk);
      const int base = rk * GEN_WIDE_SLOTS;      // the rank's first slot
      const int own_w = word_of<W>(i) - rk * W;  // i's word there
      if constexpr (kConnected) {
        unsigned seen[W];
#pragma unroll
        for (int w = 0; w < W; ++w) seen[w] = w == own_w ? bit_of<W>(i) : 0u;
        for (int k = 0; k < K(); ++k) {
          const int c = conn_l[l * K() + k];
          if (c < 0) continue;
          const float off = conn_f[l * K() + k];
#pragma unroll
          for (int w = 0; w < W; ++w) {
            unsigned bits = elig[c * W + w] & ~seen[w];
            seen[w] |= bits;
            for (; bits; bits &= bits - 1) {
              const int jl = 32 * w + __ffs(bits) - 1, j = base + jl;
              const float sc = S[c * VS + jl] + off;
              if (s_self <= sc && (sc < f_key || (sc == f_key && j > f))) {
                f_key = sc;
                f = j;
              }
              if (sc < s_self && (sc > r_key || (sc == r_key && j < r))) {
                r_key = sc;
                r = j;
              }
            }
          }
        }
      } else {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const unsigned self = w == own_w ? bit_of<W>(i) : 0u;
          for (unsigned bits = elig[l * W + w] & ~self; bits; bits &= bits - 1) {
            const int jl = 32 * w + __ffs(bits) - 1, j = base + jl;
            const float sc = S[l * VS + jl];
            if (s_self <= sc && sc <= f_key) {
              f_key = sc;
              f = j;
            }
            if (sc < s_self && sc > r_key) {
              r_key = sc;
              r = j;
            }
          }
        }
      }
    }
    *front = f;
    *rear = r;
  }

  // the free-road term of vehicle/behavior.py::Rows.accel for slot ego, with
  // the deciding slot's exponent and the ego's target speed clipped by its
  // current lane's limit; 0 where accel returns 0 without it or does not
  // read it (a Linear decider)
  __device__ float free_acc(int ego) const {
    if (ego < 0 || !(at(e.flags, ego) & FS_VEHICLE) || (kLinear && law.linear)) return 0.f;
    const int el = g.clip(at(e.lane, ego));
    const float limit = g.F(el, LF_LIMIT);
    const float ts_raw = at(e.ts, ego);
    const float ts = isinf(limit) ? ts_raw : fminf(fmaxf(ts_raw, 0.f), limit);
    const float sp = at(e.speed, ego);
    return p.comfort_acc_max * (1.0f - powf(fmaxf(sp, 0.f) / fabsf(not_zero(ts)), delta));
  }

  // vehicle/behavior.py::Rows.accel: IDM acceleration of slot ego behind
  // slot front (-1 = none), given ego's free-road term, the gap measured on
  // the ego's current lane, or the deciding slot's linear law; 0 where the
  // ego is absent or no vehicle
  __device__ float accel(int ego, int front, float free) const {
    if (ego < 0 || !(at(e.flags, ego) & FS_VEHICLE)) return 0.f;
    if (kLinear && law.linear) {
      const int el = g.clip(at(e.lane, ego));
      const bool ex = front >= 0;
      const Row er = {at(e.speed, ego), at(e.ts, ego), s_on(el, ego), 0.f, 0.f, 0.f, 0.f, true,
                      true};
      const Row fr = {ex ? at(e.speed, front) : 0.f, 0.f, ex ? s_on(el, front) : 0.f,
                      0.f, 0.f, 0.f, 0.f, ex, ex};
      return linear_accel(p.distance_wanted, law, er, fr);
    }
    if (front < 0) return free;
    const int el = g.clip(at(e.lane, ego));
    const float sp = at(e.speed, ego);
    const float d = s_on(el, front) - s_on(el, ego);
    const float c = at(e.cos, ego), sn = at(e.sin, ego);
    const float dv = (sp * c - at(e.vx, front)) * c + (sp * sn - at(e.vy, front)) * sn;
    const float d_star =
        (p.distance_wanted + sp * p.time_wanted) + (sp * dv) * p.inv_two_sqrt_ab;
    const float qd = d_star / not_zero(d);
    return free - p.comfort_acc_max * (qd * qd);
  }
};

// One slot's state, in registers for all frames of the policy step; ch / sh
// are cosf / sinf of the heading, carried from the integration to the next
// frame's start.
struct GSlot {
  float px = 0.f, py = 0.f, heading = 0.f, speed = 0.f, ts = 0.f, timer = 0.f;
  float ix = 0.f, iy = 0.f, steer = 0.f, acc = 0.f, delta = 4.f;
  float len = 5.f, wid = 2.f, gain = 0.f, max_braking = 0.f, ch = 1.f, sh = 0.f;
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
  bool inside = false;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float lx = fxs[k] * la, ly = fys[k] * wa;
    const float ppx = ax + ca * lx - sa * ly;
    const float ppy = ay + sa * lx + ca * ly;
    const float dxp = ppx - bx, dyp = ppy - by;
    const float rx = cb * dxp - sb * dyp;
    const float ry = sb * dxp + cb * dyp;
    inside = inside ||
             (-lb / 2.f <= rx && rx <= lb / 2.f && -wb / 2.f <= ry && ry <= wb / 2.f);
  }
  return inside;
}

// Calls fn(a, b) for the pairs a < b of the env's pair table taken by
// thread t of G.
template <typename Fn>
__device__ __forceinline__ void for_pairs(const unsigned short* pairs, int P, int t, int G,
                                          Fn fn) {
  for (int k = t; k < P; k += G) {
    const unsigned ab = pairs[k];
    fn(static_cast<int>(ab & 255u), static_cast<int>(ab >> 8));
  }
}

// Calls fn(a, b) for the pairs a < b of V slots taken by thread t of T, the
// k-th pair in (a, b) order on thread k % T: the pair table's enumeration,
// counted instead of stored (the cluster kernels, whose V exceeds a byte).
template <typename Fn>
__device__ __forceinline__ void for_pairs_counted(int V, int t, int T, Fn fn) {
  int a = 0, b = t + 1;
  while (a < V - 1) {
    if (b < V) {
      fn(a, b);
      b += T;
    } else {  // past row a: as far into the next row, which starts at a + 2
      ++a;
      b += a + 1 - V;
    }
  }
}

// Calls fn(m, j) for the items k = m * V + j, m < M, taken by thread t of G.
template <typename Fn>
__device__ __forceinline__ void for_items(int M, int V, int t, int G, Fn fn) {
  int m = t / V, j = t - m * V;
  while (m < M) {
    fn(m, j);
    j += G;
    while (j >= V) {
      j -= V;
      ++m;
    }
  }
}

// The projection table of the env, slot-major: thread t of G takes slot
// j = t % V and the lanes of order q, q + c, q + 2 c, ... (q = t / V < c =
// G / V), in steps every thread of the warp runs (has = false past the
// lanes, the env's end or the c V threads).  A thread writes S and LAT and,
// when `relocate` and slot j is a vehicle, keeps the smallest packed key of
// the closest lane over its lanes and merges it with one atomicMin; each
// lane's eligibility mask is the warp's ballot of the step, one atomicOr per
// lane from the thread of slot 0; kWide (an env's threads span warps, and a
// slot's bit lies in word j / 32): one atomicOr of its bit per slot eligible
// there, a handful a lane.
template <bool kWide, class LanesT>
__device__ void project_table(const LanesT& g, const EnvSmem& e, const int* lorder, int L,
                              int V, int t, int G, bool env_live, bool relocate) {
  const int c = G / V, q = t / V, j = t - q * V;
  const bool mine = env_live && q < c;
  const int steps = (L + c - 1) / c;
  const int base = (threadIdx.x & 31) - t + q * V;  // this q's first lane of the warp
  const unsigned slot_mask = kWide ? 0u : (V == 32 ? FULL_MASK : (1u << V) - 1u);
  const float px = mine ? e.px[j] : 0.f, py = mine ? e.py[j] : 0.f;
  const float hd = mine ? e.phead[j] : 0.f;
  const bool occupies = mine && (e.flags[j] & FS_OCCUPIES);
  const bool reloc = mine && relocate && (e.pflags[j] & F_VEHICLE);
  unsigned long long best = ~0ull;
  for (int step = 0; step < steps; ++step) {
    const int m = q + step * c;
    const bool has = mine && m < L;
    const int l = has ? lorder[m] : 0;
    bool on = false;
    if (has) {
      float s, lat;
      local_coords(g, l, px, py, &s, &lat);
      e.S[l * V + j] = s;
      e.LAT[l * V + j] = lat;
      // vehicle/behavior.py::eligible_on_lane
      on = occupies && fabsf(lat) <= g.F(l, LF_WIDTH) / 2.f + 1.0f && -VEHICLE_LENGTH <= s &&
           s < g.F(l, LF_LEN) + VEHICLE_LENGTH;
      // closest lane by |lat| + overrun + heading distance
      if (reloc) {
        const float dl = fabsf(lat) + fmaxf(s - g.F(l, LF_LEN), 0.f) + fmaxf(-s, 0.f) +
                         1.0f * fabsf(wrap_to_pi(hd - lane_heading(g, l, s)));
        const unsigned long long k = lane_key(dl, l);
        if (k < best) best = k;
      }
    }
    if constexpr (kWide) {
      if (on) atomicOr(&e.elig[l * GEN_WIDE_WORDS + (j >> 5)], 1u << (j & 31));
    } else {
      // bit j of the shifted ballot: slot j on this q's lane of the step
      const unsigned bits = (__ballot_sync(FULL_MASK, on) >> base) & slot_mask;
      if (has && j == 0 && bits) atomicOr(&e.elig[l], bits);
    }
  }
  if (reloc) atomicMin(&e.key[j], best);
}

// Phase B for the owner of slot i: the IDM / MOBIL decision pass and the
// controls.  kLinear: each row's own kind picks its law (a Linear row's is
// LinearVehicle's); without it every law is IDM's.  kCluster: i's own
// arrays at me = i % 128 of its block (kGlobal: its chunk), another slot's
// through cx.at.
template <bool kLinear, bool kConnected, int W, bool kCluster, bool kGlobal, bool kSized>
__device__ __forceinline__ void decide(GSlot& v,
                                       const Ctx<kLinear, kConnected, W, kCluster, kGlobal,
                                                 kSized>& cx,
                                       const Lanes<kSized>& g,
                                       const GenParams& p, const EnvSmem& e, int i, int V,
                                       int R, const int* rid) {
  const int VS = kCluster ? GEN_WIDE_SLOTS : V;  // the tables' stride
  const int me = kCluster ? i % GEN_WIDE_SLOTS : i;
  const bool idm = (v.kind == KIND_IDM || (kLinear && v.kind == KIND_LINEAR)) && !v.crashed;
  const int lane = v.lane, tlane = v.tlane;
  const int lc = g.clip(lane), tc = g.clip(tlane);
  const bool mid_change = lane != tlane;
  const float speed = v.speed;
  int target = tlane;
  float a_idm = 0.f;
  if (idm) {
    int cur_front, cur_rear;
    cx.neighbours(lane, &cur_front, &cur_rear);
    const float free_self = cx.free_acc(i);
    const float a_self = cx.accel(i, cur_front, free_self);
    const bool deciding = !mid_change && v.timer > p.lane_change_delay && v.elc;
    if (deciding) {
      v.timer = 0.f;
      const float free_rear = cx.free_acc(cur_rear);
      const float a_of = cx.accel(cur_rear, i, free_rear);
      const float a_of_pred = cx.accel(cur_rear, cur_front, free_rear);
      const int head_id = rid[clampi(v.route_ptr, 0, R - 1)];
      const bool has_rid = v.route_ptr < v.route_len && head_id >= 0;
      const int tgt_id = g.I(tc, LI_LANE_ID);
      const bool moving = fabsf(speed) >= 1.0f;
      for (int d = -1; d <= 1; d += 2) {
        const int cand_id = g.I(lc, LI_LANE_ID) + d;
        const bool exists = cand_id >= 0 && cand_id < g.I(lc, LI_EDGE_N);
        const int cand = g.clip(g.I(lc, LI_EDGE_BASE) + cand_id);
        const float s_c = e.S[cand * VS + me], lat_c = e.LAT[cand * VS + me];
        const bool reachable = fabsf(lat_c) <= 2.f * g.F(cand, LF_WIDTH) && 0.f <= s_c &&
                               s_c < g.F(cand, LF_LEN) + VEHICLE_LENGTH &&
                               !g.I(cand, LI_FORBIDDEN);
        if (!(exists && reachable && moving)) continue;
        int new_front, new_rear;
        cx.neighbours(cand, &new_front, &new_rear);
        const float free_nr = cx.free_acc(new_rear);
        const float a_nf_pred = cx.accel(new_rear, i, free_nr);
        const bool safe = a_nf_pred >= -v.max_braking;
        const float a_self_pred = cx.accel(i, new_front, free_self);
        const int dc = g.I(cand, LI_LANE_ID) - tgt_id, dh = head_id - tgt_id;
        const bool route_ok = ((dc > 0) - (dc < 0)) == ((dh > 0) - (dh < 0)) &&
                              a_self_pred >= -v.max_braking;
        const float a_nf = cx.accel(new_rear, new_front, free_nr);
        const float jerk = (a_self_pred - a_self) +
                           p.politeness * (((a_nf_pred - a_nf) + a_of_pred) - a_of);
        if (safe && (has_rid ? route_ok : jerk >= v.gain)) target = cand;
      }
    }
    // abort a lane change into a gap another controlled vehicle is
    // closing, on the same road only
    if (mid_change && g.I(lc, LI_EDGE_BASE) == g.I(tc, LI_EDGE_BASE)) {
      const float s_self = e.S[lc * VS + me];
      const float ch = e.cos[me], sh = e.sin[me], vxi = e.vx[me], vyi = e.vy[me];
      bool conflict = false;
      for (int j = 0; j < V && !conflict; ++j) {
        if (j == i || !(cx.at(e.flags, j) & FS_CONTROLLED)) continue;
        if (cx.at(e.lane, j) == tlane || cx.at(e.tlane, j) != tlane) continue;
        const float d_ij = cx.s_on(lc, j) - s_self;
        const float dv = (vxi - cx.at(e.vx, j)) * ch + (vyi - cx.at(e.vy, j)) * sh;
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
      a_idm = fminf(a_self, cx.accel(i, t_front, free_self));
    }
    a_idm = clampf(a_idm, -p.acc_max, p.acc_max);
  }
  v.tlane = target;
  // a raw-control ego keeps its stored steering and acc
  const bool is_ego = v.kind == KIND_EGO && !p.raw;
  if (is_ego || idm) {
    // steering toward the target lane's heading a pursuit distance ahead
    const int tg = g.clip(target);
    const float s = e.S[tg * VS + me], lat = e.LAT[tg * VS + me];
    const float future = lane_heading(g, tg, s + speed * p.tau_pursuit);
    if (kLinear && cx.law.linear) {
      v.steer = linear_steer(future, lat, v.heading, speed, v.len, cx.law.sp0, cx.law.sp1);
    } else {
      const float heading_cmd =
          asinf(clampf((-p.kp_lateral * lat) / not_zero(speed), -1.f, 1.f));
      const float heading_ref = future + clampf(heading_cmd, -QUARTER_PI_F, QUARTER_PI_F);
      const float rate = p.kp_heading * wrap_to_pi(heading_ref - v.heading);
      const float slip = asinf(clampf(v.len / 2.f / not_zero(speed) * rate, -1.f, 1.f));
      v.steer = clampf(atan2f(2.f * sinf(slip), cosf(slip)), -MAX_STEER_F, MAX_STEER_F);
    }
    v.acc = is_ego ? p.kp_a * (v.ts - speed) : a_idm;
  }
}

// The frame body of the kernels below: G threads an env, GEN_BLOCK / G
// envs a block (narrow), one env a block of G = GEN_WIDE_BLOCK threads
// (kWide), or one env a cluster of such blocks (kWide and kCluster; slot i
// on thread i % 128 of rank i / 128, which keeps the arrays of its 128
// slots at me = i % 128), or under kGlobal a cluster of blocks of G
// threads (slot i on thread i % G of rank i / G), the arrays of slot i in
// chunk i / 128 of the env's slab at me = i % 128.  conn_lanes /
// conn_offsets: the (L, GenParams::K)
// candidate tables, read by the kConnected instantiations alone (last, so
// that the other parameters keep their places); slab / order: kGlobal's
// per-env arrays and lanes' order by kind (null elsewhere); dyn: the kDynamical
// instantiations' DynFields, a parameter of theirs alone (an empty pack
// elsewhere); kSized: the tables' strides at run time and poly lanes, else
// the fixed layout
template <bool kRegulated, bool kLinear, bool kConnected, bool kDynamical, bool kWide,
          bool kCluster, bool kGlobal, bool kSized, typename... Dyn>
__device__ __forceinline__ void frames_body(const GenFields& f, const RegFields& rf,
                                            const float* lane_f, const int* lane_i,
                                            const GenParams& p, int B, int G,
                                            const int* conn_lanes, const float* conn_offsets,
                                            float* slab, const int* order,
                                            const Dyn... dyn) {
  static_assert(sizeof...(Dyn) == (kDynamical ? 1 : 0),
                "a kDynamical instantiation takes its DynFields, and only it");
  static_assert(kWide || !kCluster, "a cluster's blocks are the wide kernels' blocks");
  static_assert(kCluster || !kGlobal, "the global layout's env is a cluster");
  static_assert(kSized || !kGlobal, "the global layout reads the tables at run-time strides");
  constexpr int W = kWide ? GEN_WIDE_WORDS : 1;  // words of a slot mask
  constexpr int kBlock = kWide ? GEN_WIDE_BLOCK : GEN_BLOCK;
  extern __shared__ float smem[];
  const int L = p.L, V = p.V, R = p.R, M = p.M;
  // the candidates and the words of an int lane row
  const int K = kSized ? p.K : (kConnected ? GEN_FIXED_CONN : 0);
  const int iw = lane_i_words(kSized ? p.S : GEN_FIXED_SUCC, kSized);
  const int P = V * (V - 1) / 2;
  // kCluster: the cluster's blocks and this block's rank; the stride of the
  // per-slot tables (a rank's slots) and this rank's slots
  const int ranks = cluster_blocks<kCluster>(), rank = cluster_rank<kCluster>();
  const int VS = kCluster ? GEN_WIDE_SLOTS : V;
  const int V_own = kCluster ? min(GEN_WIDE_SLOTS, V - rank * GEN_WIDE_SLOTS) : V;

  // the lane tables, the lanes grouped by kind, the candidate tables
  // (kConnected), and the pair table (none under kCluster), once per block;
  // kGlobal: none, the tables read where they are
  float* lf = smem;
  int* li = reinterpret_cast<int*>(lf + L * LANE_F_WORDS);
  int* lorder = li + L * iw;
  int* conn_l = nullptr;
  float* conn_f = nullptr;
  unsigned short* pairs;
  if constexpr (kConnected) {
    conn_l = lorder + L;
    conn_f = reinterpret_cast<float*>(conn_l + L * K);
    pairs = reinterpret_cast<unsigned short*>(conn_f + L * K);
    if constexpr (!kGlobal)
      for (int k = threadIdx.x; k < L * K; k += blockDim.x) {
        conn_l[k] = conn_lanes[k];
        conn_f[k] = conn_offsets[k];
      }
  } else {
    pairs = reinterpret_cast<unsigned short*>(lorder + L);
  }
  if constexpr (!kGlobal) {
    for (int k = threadIdx.x; k < L * LANE_F_WORDS; k += blockDim.x) lf[k] = lane_f[k];
    for (int k = threadIdx.x; k < L * iw; k += blockDim.x) li[k] = lane_i[k];
    if constexpr (!kCluster)
      for (int a = threadIdx.x; a < V; a += blockDim.x) {
        const int base = a * (2 * V - a - 1) / 2;
        for (int b = a + 1; b < V; ++b)
          pairs[base + b - a - 1] = static_cast<unsigned short>(a | (b << 8));
      }
    if (threadIdx.x == 0) {
      int n = 0;
      for (int pass = 0; pass < (kSized ? 4 : 3); ++pass)
        for (int l = 0; l < L; ++l) {
          const int kind = lane_i[l * iw + LI_KIND];
          const int group = kind == LANE_CIRCULAR ? 0
                            : kind == LANE_SINE   ? 1
                            : kind == LANE_POLY   ? 3
                                                  : 2;
          if (group == pass) lorder[n++] = l;
        }
    }
    __syncthreads();
  }
  const Lanes<kSized> g = {kGlobal ? lane_f : lf, kGlobal ? lane_i : li, L, p.S, &p.poly};
  const int* lanes_order = kGlobal ? order : lorder;

  const int group = threadIdx.x / G, t = threadIdx.x % G;
  const int env = kCluster ? blockIdx.x / ranks : blockIdx.x * (kBlock / G) + group;
  const bool env_live = env < B;
  const int i = kGlobal ? rank * G + t : (kCluster ? rank * GEN_WIDE_SLOTS + t : t);
  // i's index in its block's arrays (kGlobal: its chunk's)
  const int me = kGlobal ? i % GEN_WIDE_SLOTS : (kCluster ? t : i);
  const bool live = env_live && i < V;  // this thread owns slot i
  // the projection's threads: an env's (narrow, wide) or the slot's owner
  const bool projects = kCluster ? live : env_live;
  // the threads that go over the words of this thread's arrays: the env's,
  // the block's, or under kGlobal the 128 of its chunk (tc of gc)
  const int tc = kGlobal ? me : t, gc = kGlobal ? GEN_WIDE_SLOTS : G;

  EnvSmem e;
  float* env_base;
  if constexpr (kGlobal) {
    // chunk i / 128 of the env's ranks * G / 128 in the slab
    const size_t words = EnvSmem::words(L, VS, R, kRegulated, W);
    const int chunk = i / GEN_WIDE_SLOTS;
    env_base = slab + (static_cast<size_t>(env) * (ranks * G / GEN_WIDE_SLOTS) + chunk) * words;
    e.chunks = {static_cast<ptrdiff_t>(words * sizeof(float)), chunk};
  } else {
    env_base = smem + block_words(L, kCluster ? 0 : V, g.S(), K, kSized) +
               static_cast<size_t>(group) * EnvSmem::words(L, VS, R, kRegulated, W);
  }
  e.carve(env_base, L, VS, R, kRegulated, W);
  const int phase = (kRegulated && env_live) ? rf.phase[env] : 0;

  const size_t o = static_cast<size_t>(env) * V + i;
  GSlot v;
  // kDynamical: the slot's lateral speed and yaw rate, and its DynFields
  [[maybe_unused]] DynFields df{};
  float lat_sp = 0.f, yaw = 0.f;
  if constexpr (kDynamical) {
    ((df = dyn), ...);
    if (live) {
      lat_sp = df.lateral_speed[o];
      yaw = df.yaw_rate[o];
    }
  }
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
    v.action = p.raw ? 0 : f.action[o];
    if constexpr (kRegulated) {
      v.yld = rf.is_yielding[o] != 0;
      v.yt = rf.yield_timer[o];
    }
    v.ch = cosf(v.heading);
    v.sh = sinf(v.heading);
    for (int r = 0; r < R; ++r) {
      e.rbase[me * R + r] = f.route_base[o * R + r];
      e.rn[me * R + r] = f.route_n[o * R + r];
      e.rid[me * R + r] = f.route_id[o * R + r];
    }
    e.len[me] = v.len;
    e.wid[me] = v.wid;
    e.diag[me] = sqrtf(v.len * v.len + v.wid * v.wid);
    e.px[me] = v.px;
    e.py[me] = v.py;
    e.flags[me] = ((v.active() && v.kind != KIND_LANDMARK) ? FS_OCCUPIES : 0) |
                  (v.is_vehicle() ? FS_VEHICLE : 0) | (v.is_controlled() ? FS_CONTROLLED : 0);
  }
  if (env_live)
    for (int l = tc; l < L * W; l += gc) e.elig[l] = 0u;
  group_sync<kWide, kCluster>();
  // the frame-start projection table and eligibility masks
  project_table<kWide>(g, e, lanes_order, L, VS, tc, gc, projects, false);
  group_sync<kWide, kCluster>();

  // the deciding slot's law: its kind and, on a Linear row, its parameters
  Law law = {kLinear && v.kind == KIND_LINEAR, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (law.linear) {
    law.th0 = f.accel_params[3 * o];
    law.th1 = f.accel_params[3 * o + 1];
    law.th2 = f.accel_params[3 * o + 2];
    law.sp0 = f.steer_params[2 * o];
    law.sp1 = f.steer_params[2 * o + 1];
  }
  const Ctx<kLinear, kConnected, W, kCluster, kGlobal, kSized> cx = {
      g, p, e, V, i, v.delta, law, kGlobal ? conn_lanes : conn_l,
      kGlobal ? conn_offsets : conn_f, K};
  const int* rb = e.rbase + me * R;
  const int* rn = e.rn + me * R;
  const int* rid = e.rid + me * R;

  // calls fn(a, b) for the env's pairs a < b taken by this thread: from the
  // block's pair table, or counted over the cluster's threads
  const auto each_pair = [&](auto fn) {
    if constexpr (kGlobal)
      for_pairs_counted(V, rank * G + t, ranks * G, fn);
    else if constexpr (kCluster)
      for_pairs_counted(V, rank * GEN_WIDE_BLOCK + t, ranks * GEN_WIDE_BLOCK, fn);
    else
      for_pairs(pairs, P, t, G, fn);
  };
  // the swept SAT of the post-integration rows of slots a < b
  const auto sat_slots = [&](int a, int b, bool* inter, bool* will, float* tx, float* ty) {
    sat(cx.at(e.px, a), cx.at(e.py, a), cx.at(e.len, a), cx.at(e.wid, a), cx.at(e.pcos, a),
        cx.at(e.psin, a), cx.at(e.px, b), cx.at(e.py, b), cx.at(e.len, b), cx.at(e.wid, b),
        cx.at(e.pcos, b), cx.at(e.psin, b), (cx.at(e.pvx, a) - cx.at(e.pvx, b)) * p.dt,
        (cx.at(e.pvy, a) - cx.at(e.pvy, b)) * p.dt, inter, will, tx, ty);
  };

  for (int frame = 0; frame < p.frames; ++frame) {
    // --- A: follow_road, then the ego meta-action on frame 0 --------------
    if (live) {
      const int lt = g.clip(v.tlane);
      const float s_t = e.S[lt * VS + me];
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
          for (int k = 0; k < g.S(); ++k) {
            const int sb = g.succ_base(lt, k);
            if (sb < 0) continue;
            const int cl = lane_on_edge(g, lt, sb, g.succ_n(lt, k), -1, projx, projy, M, &dist);
            if (dist < best) {
              best = dist;
              next = cl;
            }
          }
        }
        v.tlane = next;
        v.route_ptr = new_ptr;
      }
      if (frame == 0 && v.kind == KIND_EGO && !p.raw) {
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
        if (fa || sl) v.ts = kSized ? p.speed_grid[idx] : p.target_speeds[idx];
        v.speed_index = idx;
        const int lt2 = g.clip(v.tlane);
        const int d_id = lr ? 1 : (ll ? -1 : 0);
        const int cand = g.I(lt2, LI_EDGE_BASE) +
                         min(max(g.I(lt2, LI_LANE_ID) + d_id, 0), g.I(lt2, LI_EDGE_N) - 1);
        const int cl = g.clip(cand);
        const float s_c = e.S[cl * VS + me], lat_c = e.LAT[cl * VS + me];
        const bool reach = fabsf(lat_c) <= 2.f * g.F(cl, LF_WIDTH) && 0.f <= s_c &&
                           s_c < g.F(cl, LF_LEN) + VEHICLE_LENGTH &&
                           !g.I(cl, LI_FORBIDDEN);
        if ((ll || lr) && reach) v.tlane = cand;
      }
      e.speed[me] = v.speed;
      e.ts[me] = v.ts;
      e.cos[me] = v.ch;
      e.sin[me] = v.sh;
      e.vx[me] = v.speed * v.ch;
      e.vy[me] = v.speed * v.sh;
      e.lane[me] = v.lane;
      e.tlane[me] = v.tlane;
    }
    group_sync<kWide, kCluster>();

    // --- B: the IDM / MOBIL decision pass and the controls ----------------
    if (live) decide(v, cx, g, p, e, i, V, R, rid);
    group_sync<kWide, kCluster>();  // the frame-start table and eligibility masks are read

    // --- B': the right-of-way pass on the env's tick frames ----------------
    // road/regulation.py::enforce_road_rules on the frame-start state (after
    // follow_road and the meta-action); writes v.ts, v.yld, v.yt
    if constexpr (kRegulated) {
      const bool tick = env_live && (phase + frame + 1) % p.period == 0;
      if (__any_sync(FULL_MASK, tick)) {
        if (tick && tc < W) e.bits[2 * W + tc] = 0u;
        if (tick && live) {
          // the constant-speed route walk's segments (predict_route_positions)
          const int lc = g.clip(v.lane);
          const bool has_rt = v.route_ptr < v.route_len;
          const int cur_id = g.I(lc, LI_LANE_ID);
          unsigned valid = 0u;  // the fixed layout's routes: at most 16 slots
          float acc = 0.f;
          int n_valid = 0, first = -1;
          for (int q = 0; q < R; ++q) {
            const bool ok = has_rt && q >= v.route_ptr && q < v.route_len;
            const int fallback = cur_id < rn[q] ? cur_id : 0;
            const int seg_id = rid[q] >= 0 ? rid[q] : fallback;
            const int seg = ok ? clampi(rb[q] + seg_id, 0, g.L - 1) : v.lane;
            acc = acc + (ok ? g.F(g.clip(seg), LF_LEN) : 0.f);
            e.rcum[me * R + q] = acc;
            e.rseg[me * R + q] = seg;
            if (ok) {
              if constexpr (!kSized) valid |= 1u << q;
              ++n_valid;
              if (first < 0) first = q;
            }
          }
          first = max(first, 0);
          e.rfirst[me] = first;
          e.rlast[me] = n_valid > 0 ? first + n_valid - 1 : 0;
          e.rvalid[me] = static_cast<int>(valid);
          e.rs0[me] = e.S[lc * VS + me];
          e.fx[me] = v.px;
          e.fy[me] = v.py;
          e.prio[me] = g.priority(lc);
        }
        // every read of S / LAT is done: the predictions take their words
        group_sync<kWide, kCluster>();
        // every slot's positions and headings at the 11 times, item (t, j)
        // (kCluster: the rank's own slots, j its index there; kGlobal: the
        // owner's 11 items, j = me in its chunk)
        const auto predict = [&](int tt, int j) {
          const int first = e.rfirst[j], last = e.rlast[j];
          const float* cum = e.rcum + j * R;
          const float target =
              e.rs0[j] + e.speed[j] * (REG_STEP * static_cast<float>(tt + 1));
          // the valid segments before the last that the target passes:
          // kSized (any number of route slots) the run [first, last), which
          // the valid slots are; else by the valid mask
          int k = first;
          if constexpr (kSized) {
            for (int q = first; q < last; ++q)
              if (target > cum[q]) ++k;
          } else {
            const unsigned valid = static_cast<unsigned>(e.rvalid[j]);
            for (int q = 0; q < R; ++q)
              if (target > cum[q] && q < last && ((valid >> q) & 1u)) ++k;
          }
          k = min(k, last);
          const int lk = g.clip(e.rseg[j * R + k]);
          const float base = k > first ? cum[k - 1] : 0.f;
          const float s_loc = target - base;
          float x, y;
          lane_position(g, lk, s_loc, 0.f, &x, &y);
          const float h = lane_heading(g, lk, s_loc);
          e.qx[tt * VS + j] = x;
          e.qy[tt * VS + j] = y;
          e.qc[tt * VS + j] = cosf(h);
          e.qs[tt * VS + j] = sinf(h);
        };
        if constexpr (kGlobal) {
          if (tick && live)
            for (int tt = 0; tt < REG_TIMES; ++tt) predict(tt, me);
        } else if (tick) {
          for_items(REG_TIMES, V_own, t, G, predict);
        }
        group_sync<kWide, kCluster>();
        // future overlaps of every pair of vehicles (lower, upper), each
        // pair on one thread; the yielder's bit
        if (tick)
          each_pair([&](int a, int b) {
            if (!(cx.at(e.flags, a) & FS_VEHICLE) || !(cx.at(e.flags, b) & FS_VEHICLE)) return;
            const float la = 1.5f * cx.at(e.len, a), wa = 0.9f * cx.at(e.wid, a);
            const float lb = 1.5f * cx.at(e.len, b), wb = 0.9f * cx.at(e.wid, b);
            const float reach2 = cx.at(e.len, a) * cx.at(e.len, a);
            bool conflict = false;
            for (int tt = 0; tt < REG_TIMES && !conflict; ++tt) {
              float *qx = e.qx + tt * VS, *qy = e.qy + tt * VS;
              float *qc = e.qc + tt * VS, *qs = e.qs + tt * VS;
              const float dx = cx.at(qx, b) - cx.at(qx, a), dy = cx.at(qy, b) - cx.at(qy, a);
              if (!(dx * dx + dy * dy <= reach2)) continue;
              conflict = probes_inside(cx.at(qx, a), cx.at(qy, a), la, wa, cx.at(qc, a),
                                       cx.at(qs, a), cx.at(qx, b), cx.at(qy, b), lb, wb,
                                       cx.at(qc, b), cx.at(qs, b)) ||
                         probes_inside(cx.at(qx, b), cx.at(qy, b), lb, wb, cx.at(qc, b),
                                       cx.at(qs, b), cx.at(qx, a), cx.at(qy, a), la, wa,
                                       cx.at(qc, a), cx.at(qs, a));
            }
            if (!conflict) return;
            // the lower priority yields; on a tie the one less far ahead
            const int pa = cx.at(e.prio, a), pb = cx.at(e.prio, b);
            bool a_yields;
            if (pa != pb) {
              a_yields = pa < pb;
            } else {
              const float dx0 = cx.at(e.fx, b) - cx.at(e.fx, a);
              const float dy0 = cx.at(e.fy, b) - cx.at(e.fy, a);
              const float front_ab = dx0 * cx.at(e.cos, a) + dy0 * cx.at(e.sin, a);
              const float front_ba = (-dx0) * cx.at(e.cos, b) + (-dy0) * cx.at(e.sin, b);
              a_yields = front_ab > front_ba;
            }
            set_slot<kCluster, kGlobal, W>(e.chunks, e.bits + 2 * W, a_yields ? a : b);
          });
        group_sync<kWide, kCluster>();  // the predictions are read: the rows take their words back
        if (tick && live) {
          const bool new_yield = has_slot<W>(e.bits + 2 * W, me) &&
                                 (v.kind == KIND_IDM || v.kind == KIND_LINEAR);
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
      }
    }

    // --- C: integration and the post-integration rows ---------------------
    if (live) {
      if (v.is_vehicle()) {
        const float speed = v.speed;
        const float st_angle = v.crashed ? 0.f : v.steer;
        float ac = v.crashed ? -1.0f * speed : v.acc;
        ac = speed > MAX_SPEED ? fminf(ac, MAX_SPEED - speed)
                               : (speed < MIN_SPEED ? fmaxf(ac, MIN_SPEED - speed) : ac);
        const float beta = atanf(0.5f * tanf(st_angle));
        const float hb = v.heading + beta;
        // kDynamical: the ego's pre-integration row, the RK4's input
        float s6[6] = {v.px, v.py, v.heading, speed, lat_sp, yaw};
        v.px = (v.px + (speed * cosf(hb)) * p.dt) + (v.pend ? v.ix : 0.f);
        v.py = (v.py + (speed * sinf(hb)) * p.dt) + (v.pend ? v.iy : 0.f);
        v.crashed = v.crashed || v.pend;
        v.heading = v.heading + speed * sinf(beta) / (v.len / 2.f) * p.dt;
        v.speed = speed + ac * p.dt;
        v.ix = 0.f;
        v.iy = 0.f;
        v.pend = false;
        v.timer = v.timer + p.dt;
        if constexpr (kDynamical) {
          // the ego's position (without the impact), heading and speed from
          // one RK4 step; it keeps the crash, impact and timer updates above
          if (v.kind == KIND_EGO) {
            s6[5] = clamp_keep_nan(yaw, -TWO_PI_F, TWO_PI_F);
            bicycle_rk4(s6, clamp_keep_nan(st_angle, -HALF_PI_F, HALF_PI_F), ac, p.dt, df);
            v.px = s6[0];
            v.py = s6[1];
            v.heading = s6[2];
            v.speed = s6[3];
            lat_sp = s6[4];
            yaw = s6[5];
          }
        }
      }
      v.ch = cosf(v.heading);
      v.sh = sinf(v.heading);
      e.px[me] = v.px;
      e.py[me] = v.py;
      e.phead[me] = v.heading;
      e.pspeed[me] = v.speed;
      e.pcos[me] = v.ch;
      e.psin[me] = v.sh;
      e.pvx[me] = v.speed * v.ch;
      e.pvy[me] = v.speed * v.sh;
      const bool solid = v.active() && v.kind != KIND_LANDMARK;
      e.pflags[me] = (v.active() ? F_ACTIVE : 0) | (v.is_vehicle() ? F_VEHICLE : 0) |
                     (v.chk ? F_CHECK : 0) | (v.coll ? F_COLLIDABLE : 0) |
                     (solid ? F_SOLID : 0) | (v.kind == KIND_OBSTACLE ? F_OBSTACLE : 0);
      e.key[me] = ~0ull;
      for (int w = 0; w < W; ++w) e.imp[me * W + w] = 0u;
    }
    if (env_live) {
      for (int l = tc; l < L * W; l += gc) e.elig[l] = 0u;
      if (tc < W) e.bits[tc] = e.bits[W + tc] = 0u;
    }
    group_sync<kWide, kCluster>();

    // --- C': the new projection table and re-localization, slot-major -------
    project_table<kWide>(g, e, lanes_order, L, VS, tc, gc, projects, true);
    // --- D: collisions, each pair once: sphere pre-check, swept SAT, slot bits
    // (no barrier between C' and D: they touch other words)
    if (env_live)
      each_pair([&](int a, int b) {
        const int fa = cx.at(e.pflags, a), fb = cx.at(e.pflags, b);
        if (!pair_eligible(fa, fb)) return;
        const float dx = cx.at(e.px, a) - cx.at(e.px, b), dy = cx.at(e.py, a) - cx.at(e.py, b);
        const float reach = (cx.at(e.diag, a) + cx.at(e.diag, b)) / 2.f + cx.at(e.pspeed, a) * p.dt;
        if (!(dx * dx + dy * dy <= reach * reach)) return;
        bool inter, will;
        float tx, ty;
        sat_slots(a, b, &inter, &will, &tx, &ty);
        const bool both_solid = (fa & F_SOLID) && (fb & F_SOLID);
        const unsigned ba = bit_of<W>(a), bb = bit_of<W>(b);
        if constexpr (W == 1) {
          if (inter && both_solid) atomicOr(&e.bits[0], ba | bb);
          if (inter && !both_solid)
            atomicOr(&e.bits[1], ((fa & F_SOLID) ? 0u : ba) | ((fb & F_SOLID) ? 0u : bb));
        } else {  // a and b may lie in different words
          if (inter && both_solid) {
            set_slot<kCluster, kGlobal, W>(e.chunks, e.bits, a);
            set_slot<kCluster, kGlobal, W>(e.chunks, e.bits, b);
          }
          if (inter && !both_solid) {
            if (!(fa & F_SOLID)) set_slot<kCluster, kGlobal, W>(e.chunks, e.bits + W, a);
            if (!(fb & F_SOLID)) set_slot<kCluster, kGlobal, W>(e.chunks, e.bits + W, b);
          }
        }
        if (will && both_solid) {
          if constexpr (kCluster) {  // the highest partner, + 1, in the slot's first word
            const auto first_word = [&](int k) {
              return peer<true, kGlobal>(e.chunks, e.imp + k % GEN_WIDE_SLOTS * W,
                                         k / GEN_WIDE_SLOTS);
            };
            if (!(fa & F_OBSTACLE)) atomicMax(first_word(a), static_cast<unsigned>(b + 1));
            if (!(fb & F_OBSTACLE)) atomicMax(first_word(b), static_cast<unsigned>(a + 1));
          } else {
            if (!(fa & F_OBSTACLE)) atomicOr(&e.imp[a * W + word_of<W>(b)], bb);
            if (!(fb & F_OBSTACLE)) atomicOr(&e.imp[b * W + word_of<W>(a)], ba);
          }
        }
      });
    group_sync<kWide, kCluster>();

    // --- D': the closest lane, crash / hit flags, the last-write impact ----
    if (live) {
      if (v.is_vehicle()) v.lane = static_cast<int>(e.key[me] & 0xffffffffull);
      // the highest partner, from the top word down: every partner above i
      // outranks every one below (row before column), and ascending order
      // leaves the last write; the full translation against an obstacle,
      // half each between two vehicles
      int j = -1;
      if constexpr (kCluster) {
        j = static_cast<int>(e.imp[me * W]) - 1;
      } else {
#pragma unroll
        for (int w = W - 1; w >= 0; --w) {
          const unsigned partners = e.imp[i * W + w];
          if (j < 0 && partners) j = 32 * w + 31 - __clz(partners);
        }
      }
      if (j >= 0) {
        bool inter, will;
        float tx, ty;
        sat_slots(min(i, j), max(i, j), &inter, &will, &tx, &ty);
        const bool other_obstacle = (cx.at(e.pflags, j) & F_OBSTACLE) != 0;
        const float coef = other_obstacle ? 1.0f : (j > i ? 0.5f : -0.5f);
        v.ix = coef * tx;
        v.iy = coef * ty;
        v.pend = true;
      }
      v.crashed = v.crashed || has_slot<W>(e.bits, me);
      v.hit = v.hit || has_slot<W>(e.bits + W, me);
    }
    // the next frame's phase A writes only frame-start rows, which nothing
    // reads until after its barrier; the words read here are rewritten
    // after two more barriers
  }
  // kCluster: no block leaves while another rank may still read its shared
  // memory (phase D' of the last frame)
  if constexpr (kCluster) group_sync<kWide, kCluster>();

  if (!kLinear) trap_on_rows(live && v.kind == KIND_LINEAR);
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
    if constexpr (kDynamical) {
      df.lateral_speed_out[o] = lat_sp;
      df.yaw_rate_out[o] = yaw;
    }
  }
}

// The narrow kernels: G = 16 or 32 threads an env within one warp.
template <bool kRegulated, bool kLinear, bool kConnected, bool kDynamical, bool kSized,
          typename... Dyn>
__global__ void __launch_bounds__(GEN_BLOCK)
    general_frames_kernel(const __grid_constant__ GenFields f,
                          const __grid_constant__ RegFields rf, const float* lane_f,
                          const int* lane_i, const __grid_constant__ GenParams p, int B,
                          int G, const int* conn_lanes, const float* conn_offsets,
                          const Dyn... dyn) {
  frames_body<kRegulated, kLinear, kConnected, kDynamical, false, false, false, kSized>(
      f, rf, lane_f, lane_i, p, B, G, conn_lanes, conn_offsets, nullptr, nullptr, dyn...);
}

// Blocks an SM the wide kernels are built for: 5 for the IDM K4 of the fixed
// layout (kinematic or connected), the occupancy ptxas chose for it before
// the tables were sized (96 registers and 28-40 bytes of spill; left to
// itself it now takes 117-121 and 4 blocks, 1.05-1.07x the time: kernel_ab,
// PERF.md), else none asked.
template <bool kRegulated, bool kLinear, bool kDynamical, bool kSized>
constexpr int wide_min_blocks() {
  return (!kRegulated && !kLinear && !kDynamical && !kSized) ? 5 : 1;
}

// The wide kernels: one env a block of G = GEN_WIDE_BLOCK threads.
template <bool kRegulated, bool kLinear, bool kConnected, bool kDynamical, bool kSized,
          typename... Dyn>
__global__ void __launch_bounds__(GEN_WIDE_BLOCK,
                                  wide_min_blocks<kRegulated, kLinear, kDynamical, kSized>())
    general_frames_wide_kernel(const __grid_constant__ GenFields f,
                               const __grid_constant__ RegFields rf, const float* lane_f,
                               const int* lane_i, const __grid_constant__ GenParams p, int B,
                               int G, const int* conn_lanes, const float* conn_offsets,
                               const Dyn... dyn) {
  frames_body<kRegulated, kLinear, kConnected, kDynamical, true, false, false, kSized>(
      f, rf, lane_f, lane_i, p, B, G, conn_lanes, conn_offsets, nullptr, nullptr, dyn...);
}

// The cluster kernels: one env a cluster of ceil(V / 128) blocks of
// G = GEN_WIDE_BLOCK threads (the cluster's size is the launch's attribute).
template <bool kRegulated, bool kLinear, bool kConnected, bool kDynamical, bool kSized,
          typename... Dyn>
__global__ void __launch_bounds__(GEN_WIDE_BLOCK)
    general_frames_cluster_kernel(const __grid_constant__ GenFields f,
                                  const __grid_constant__ RegFields rf, const float* lane_f,
                                  const int* lane_i, const __grid_constant__ GenParams p,
                                  int B, int G, const int* conn_lanes,
                                  const float* conn_offsets, const Dyn... dyn) {
  frames_body<kRegulated, kLinear, kConnected, kDynamical, true, true, false, kSized>(
      f, rf, lane_f, lane_i, p, B, G, conn_lanes, conn_offsets, nullptr, nullptr, dyn...);
}

// The global kernels: one env a cluster of ceil(V / G) blocks of G = 128,
// 256 or 512 threads (global_threads), its arrays in the slab (a float
// array of global_words(...) words an env) and the lanes' order by kind
// the wrapper's; at most 128 registers a thread, so that a block of 512
// threads fits an SM.
template <bool kRegulated, bool kLinear, bool kConnected, bool kDynamical, bool kSized,
          typename... Dyn>
__global__ void __launch_bounds__(GEN_GLOBAL_THREADS)
    general_frames_global_kernel(const __grid_constant__ GenFields f,
                                 const __grid_constant__ RegFields rf, const float* lane_f,
                                 const int* lane_i, const __grid_constant__ GenParams p, int B,
                                 int G, const int* conn_lanes, const float* conn_offsets,
                                 float* slab, const int* order, const Dyn... dyn) {
  frames_body<kRegulated, kLinear, kConnected, kDynamical, true, true, true, kSized>(
      f, rf, lane_f, lane_i, p, B, G, conn_lanes, conn_offsets, slab, order, dyn...);
}

// Threads an env: 16 up to 16 slots, else 32 (32 at V <= 16 ran 1.29x to
// 1.50x slower at roundabout-v0, merge-v0 and the V = 16 warm-up; PERF.md).
static int threads_per_env(int V) { return V <= 16 ? 16 : 32; }

// Threads a block of the global kernels at V slots: the fewest of 128, 256
// and 512 whose GEN_CLUSTER_BLOCKS blocks hold V.
static int global_threads(int V) {
  int threads = GEN_WIDE_BLOCK;
  while (threads < GEN_GLOBAL_THREADS && (V + threads - 1) / threads > GEN_CLUSTER_BLOCKS)
    threads *= 2;
  return threads;
}

// The words of one env's slab in the global layout: the chunks of 128
// slots of its ceil(V / G) blocks of G = global_threads(V) threads, each
// EnvSmem's words at V = 128 and W = GEN_WIDE_WORDS.
static long long global_words(bool regulated, int L, int V, int R) {
  const int G = global_threads(V);
  const long long chunks = static_cast<long long>((V + G - 1) / G) * (G / GEN_WIDE_SLOTS);
  return chunks * EnvSmem::words(L, GEN_WIDE_SLOTS, R, regulated, GEN_WIDE_WORDS);
}

// The dynamic shared memory a launch asks of each block: the block's words
// and those of each env it holds (a cluster's blocks hold no pair table and
// the arrays of 128 slots each, the same at any V; the global kernels'
// none).  The scene sizes every
// table (L lanes, R route slots, S successor edges and, kConnected, K
// candidates a lane); the one limit is the card's shared memory a block,
// which ops/general_frames.py::launch_smem computes alike for make.
template <bool kRegulated, bool kConnected, bool kWide, bool kCluster, bool kGlobal, bool kSized>
static size_t launch_smem(int L, int V, int R, int S, int K) {
  if constexpr (kGlobal) return 0;
  const int block = kWide ? GEN_WIDE_BLOCK : GEN_BLOCK;
  const int G = kWide ? GEN_WIDE_BLOCK : threads_per_env(V);
  return sizeof(float) *
         (static_cast<size_t>(block_words(L, kCluster ? 0 : V, S, kConnected ? K : 0, kSized)) +
          static_cast<size_t>(block / G) *
              EnvSmem::words(L, kCluster ? GEN_WIDE_SLOTS : V, R, kRegulated,
                             kWide ? GEN_WIDE_WORDS : 1));
}

// The launch configuration of B clusters of `ranks` blocks of `threads`
// threads (GEN_WIDE_BLOCK, or global_threads), each block asking `smem`
// bytes; `attr` receives the cluster dimension, which the configuration
// points to.
static cudaLaunchConfig_t cluster_config(int ranks, int B, size_t smem, cudaStream_t stream,
                                         cudaLaunchAttribute* attr,
                                         int threads = GEN_WIDE_BLOCK) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(ranks);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((B > 0 ? B : 1) * ranks));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The kernel of a layout and law: the Linear rows' instantiation or the
// IDM code's; with kSized both are the kSized instantiation (Linear rows
// possible), so a library instantiates only its own kernels.
template <bool kRegulated, bool kConnected, bool kDynamical, bool kWide, bool kCluster,
          bool kGlobal, bool kSized, typename... Dyn>
static auto kernel_of(bool linear) {
  if constexpr (kGlobal)
    return linear
               ? general_frames_global_kernel<kRegulated, true, kConnected, kDynamical, kSized,
                                              Dyn...>
               : general_frames_global_kernel<kRegulated, kSized, kConnected, kDynamical,
                                              kSized, Dyn...>;
  else if constexpr (kCluster)
    return linear
               ? general_frames_cluster_kernel<kRegulated, true, kConnected, kDynamical, kSized,
                                               Dyn...>
               : general_frames_cluster_kernel<kRegulated, kSized, kConnected, kDynamical,
                                               kSized, Dyn...>;
  else if constexpr (kWide)
    return linear
               ? general_frames_wide_kernel<kRegulated, true, kConnected, kDynamical, kSized,
                                            Dyn...>
               : general_frames_wide_kernel<kRegulated, kSized, kConnected, kDynamical, kSized,
                                            Dyn...>;
  else
    return linear
               ? general_frames_kernel<kRegulated, true, kConnected, kDynamical, kSized, Dyn...>
               : general_frames_kernel<kRegulated, kSized, kConnected, kDynamical, kSized,
                                       Dyn...>;
}

// dyn: the kDynamical instantiations' DynFields (one pointer), or nothing;
// kWide: the wide kernels (up to GEN_WIDE_SLOTS slots), with kCluster the
// cluster kernels (up to GEN_CLUSTER_SLOTS), with kGlobal too the global
// ones (up to GEN_GLOBAL_SLOTS; ptrs then holds two more pointers past the
// outputs: the slab, global_words(...) floats an env, and the (L,) int32
// lanes' order by kind), else the narrow ones (up to GEN_MAX_SLOTS)
template <bool kRegulated, bool kConnected, bool kWide, bool kCluster, bool kGlobal, bool kSized,
          typename... Dyn>
static int launch(void* const* ptrs, const RegFields& rf, const float* lane_f,
                  const int* lane_i, const int* conn_lanes, const float* conn_offsets,
                  const GenParams* params, int B, void* stream, const Dyn*... dyn) {
  static_assert(sizeof(GenFields) == (N_IN + 1 + N_OUT) * sizeof(void*),
                "GenFields holds one pointer per tensor");
  constexpr bool kDynamical = sizeof...(Dyn) > 0;
  constexpr int max_slots =
      kGlobal ? GEN_GLOBAL_SLOTS
              : (kCluster ? GEN_CLUSTER_SLOTS : (kWide ? GEN_WIDE_SLOTS : GEN_MAX_SLOTS));
  const GenParams& p = *params;
  float* slab = nullptr;
  const int* order = nullptr;
  if constexpr (kGlobal) {
    slab = static_cast<float*>(ptrs[N_IN + 1 + N_OUT]);
    order = static_cast<const int*>(ptrs[N_IN + 2 + N_OUT]);
  }
  if (p.V < 1 || p.V > max_slots || p.L < 1 || p.R < 1 || p.M < 1 || p.M > p.L || p.S < 0 ||
      (p.raw ? p.n_speeds != 0 : (p.n_speeds < 1 || (kSized && !p.speed_grid))) ||
      (kRegulated && p.period < 1) ||
      (kConnected ? (p.K < 1 || !conn_lanes || !conn_offsets) : p.K != 0) ||
      // the fixed library's layout: padded successors and candidates,
      // routes of at most 16 slots, at most 16 speeds and no poly bank
      (!kSized && (p.S != GEN_FIXED_SUCC || (kConnected && p.K != GEN_FIXED_CONN) ||
                   p.R > GEN_FIXED_ROUTE || p.n_speeds > GEN_FIXED_SPEEDS ||
                   p.poly.pos != nullptr)) ||
      (kGlobal && (!slab || !order)) || (false || ... || (dyn == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  GenFields f;
  memcpy(&f, ptrs, sizeof(GenFields));
  const int block = kWide ? GEN_WIDE_BLOCK : GEN_BLOCK;
  const int G = kGlobal ? global_threads(p.V) : (kWide ? GEN_WIDE_BLOCK : threads_per_env(p.V));
  const int envs_per_block = block / G;
  const size_t smem =
      launch_smem<kRegulated, kConnected, kWide, kCluster, kGlobal, kSized>(p.L, p.V, p.R, p.S,
                                                                          p.K);
  // the Linear rows' instantiation where the caller says they are possible
  // (the kSized library's one always); only this library's kernels
  // (narrow, wide, cluster or global, fixed or sized) are instantiated
  const auto kernel =
      kernel_of<kRegulated, kConnected, kDynamical, kWide, kCluster, kGlobal, kSized, Dyn...>(
          p.linear);
  int dev = 0;
  if (smem > 48 * 1024 || kCluster) {
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (smem > 48 * 1024) {
    // above the default only by the attribute, set once per kernel and card
    // for the largest size asked so far: a launch under stream capture after
    // an eager one of the same shape calls no function attribute
    static size_t allowed[2][64] = {};
    size_t& set = allowed[p.linear ? 1 : 0][dev & 63];
    if (smem > set) {
      cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      set = smem;
    }
  }
  if constexpr (kCluster) {
    // one env a cluster of ceil(V / G) blocks, B clusters
    const int ranks = (p.V + G - 1) / G;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg =
        cluster_config(ranks, B, smem, static_cast<cudaStream_t>(stream), &attr, G);
    if (ranks > GEN_PORTABLE_CLUSTER) {
      // a cluster over the portable size only by the attribute, set once
      // per kernel and card before the occupancy query and the launch: a
      // launch under stream capture calls no function attribute
      static bool nonportable[2][64] = {};
      bool& set = nonportable[p.linear ? 1 : 0][dev & 63];
      if (!set) {
        cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return static_cast<int>(e);
        set = true;
      }
    }
    // whether such a cluster fits the card's SMs at all, asked once per
    // kernel, card and cluster size (kGlobal: and block size) for the
    // largest shared memory asked so far (no query under stream capture
    // after an eager launch of the same shape); none fits: the launch's
    // error, which the wrapper raises.  fit holds the bytes asked + 1 (0:
    // never asked), since the global kernels ask none
    static size_t fits[2][64][GEN_CLUSTER_BLOCKS + 1][3] = {};
    size_t& fit = fits[p.linear ? 1 : 0][dev & 63][ranks][G / (2 * GEN_WIDE_BLOCK)];
    if (smem + 1 > fit) {
      int clusters = 0;
      cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
      fit = smem + 1;
    }
    if (B > 0) {
      cudaError_t e;
      if constexpr (kGlobal)
        e = cudaLaunchKernelEx(&cfg, kernel, f, rf, lane_f, lane_i, p, B, G, conn_lanes,
                               conn_offsets, slab, order, *dyn...);
      else
        e = cudaLaunchKernelEx(&cfg, kernel, f, rf, lane_f, lane_i, p, B, G, conn_lanes,
                               conn_offsets, *dyn...);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  } else if (B > 0) {
    const int blocks = (B + envs_per_block - 1) / envs_per_block;
    kernel<<<blocks, block, smem, static_cast<cudaStream_t>(stream)>>>(
        f, rf, lane_f, lane_i, p, B, G, conn_lanes, conn_offsets, *dyn...);
  }
  return static_cast<int>(cudaGetLastError());
}

// This source builds the narrow library; general_frames_wide.cu includes it
// with GEN_WIDE_LIBRARY defined and builds the wide one,
// general_frames_cluster.cu with GEN_CLUSTER_LIBRARY defined the cluster
// one, and general_frames_global.cu with GEN_GLOBAL_LIBRARY defined the
// global one, whose entries below have the same names and launch the wide,
// the cluster or the global kernels.
#if defined(GEN_GLOBAL_LIBRARY)
#define GEN_LAYOUT_ONLY true, true, true
#elif defined(GEN_CLUSTER_LIBRARY)
#define GEN_LAYOUT_ONLY true, true, false
#elif defined(GEN_WIDE_LIBRARY)
#define GEN_LAYOUT_ONLY true, false, false
#else
#define GEN_LAYOUT_ONLY false, false, false
#endif
// general_frames_sized.cu, general_frames_wide_sized.cu and
// general_frames_cluster_sized.cu define GEN_SIZED_LIBRARY too: the same
// entries launching the kSized instantiations, built beside the fixed ones;
// the global library has only those
#if defined(GEN_SIZED_LIBRARY) || defined(GEN_GLOBAL_LIBRARY)
#define GEN_SIZED true
#else
#define GEN_SIZED false
#endif
#define GEN_LAYOUT GEN_LAYOUT_ONLY, GEN_SIZED
#if defined(GEN_GLOBAL_LIBRARY)
#define GEN_GLOBAL true
#else
#define GEN_GLOBAL false
#endif

// ptrs: the N_IN input tensors, the (B, V) int32 slot actions (null with
// GenParams::raw, never read) and the N_OUT output tensors, as device
// pointers in GenFields' order; lane_f / lane_i:
// the (L, LANE_F_WORDS) float and (L, lane_i_words(S)) int lane tables on
// the device.  Launches K4 on `stream` without synchronizing; returns the
// CUDA error code (cudaErrorInvalidValue for a parameter block that does
// not describe a scene).
extern "C" int general_frames(void* const* ptrs, const float* lane_f, const int* lane_i,
                              const GenParams* params, int B, void* stream) {
  return launch<false, false, GEN_LAYOUT>(ptrs, RegFields{}, lane_f, lane_i, nullptr, nullptr,
                                        params, B, stream);
}

// The size of GenParams, which the wrapper holds its ctypes mirror to.
extern "C" int general_params_bytes() { return static_cast<int>(sizeof(GenParams)); }

// The shared memory a block of this library's launch asks at a scene of V
// slots, L lanes, R route slots, S successor edges and (connected) K
// candidates a lane: what ops/general_frames.py::launch_smem is held to.
extern "C" long long general_smem_bytes(int regulated, int connected, int L, int V, int R,
                                        int S, int K) {
  using Smem = size_t (*)(int, int, int, int, int);
  static const Smem sizes[4] = {
      launch_smem<false, false, GEN_LAYOUT>, launch_smem<false, true, GEN_LAYOUT>,
      launch_smem<true, false, GEN_LAYOUT>, launch_smem<true, true, GEN_LAYOUT>};
  return static_cast<long long>(sizes[2 * (regulated != 0) + (connected != 0)](L, V, R, S, K));
}

// K5: as general_frames, plus reg_ptrs, the device pointers of RegFields in
// its order.
extern "C" int general_frames_regulated(void* const* ptrs, void* const* reg_ptrs,
                                        const float* lane_f, const int* lane_i,
                                        const GenParams* params, int B, void* stream) {
  static_assert(sizeof(RegFields) == 5 * sizeof(void*), "RegFields holds five pointers");
  RegFields rf;
  memcpy(&rf, reg_ptrs, sizeof(RegFields));
  return launch<true, false, GEN_LAYOUT>(ptrs, rf, lane_f, lane_i, nullptr, nullptr, params, B,
                                       stream);
}

// The connected-lane search's K4: as general_frames, plus conn_lanes /
// conn_offsets, the (L, GenParams::K) int candidate lanes (-1 pad) and float
// offsets of ops/general_frames.py::conn_tables on the device.
extern "C" int general_frames_connected(void* const* ptrs, const float* lane_f,
                                        const int* lane_i, const int* conn_lanes,
                                        const float* conn_offsets, const GenParams* params,
                                        int B, void* stream) {
  return launch<false, true, GEN_LAYOUT>(ptrs, RegFields{}, lane_f, lane_i, conn_lanes,
                                       conn_offsets, params, B, stream);
}

// The connected-lane search's K5: as general_frames_regulated, plus the
// candidate tables of general_frames_connected.
extern "C" int general_frames_regulated_connected(void* const* ptrs, void* const* reg_ptrs,
                                                  const float* lane_f, const int* lane_i,
                                                  const int* conn_lanes,
                                                  const float* conn_offsets,
                                                  const GenParams* params, int B,
                                                  void* stream) {
  RegFields rf;
  memcpy(&rf, reg_ptrs, sizeof(RegFields));
  return launch<true, true, GEN_LAYOUT>(ptrs, rf, lane_f, lane_i, conn_lanes, conn_offsets, params,
                                      B, stream);
}

// The size of DynFields, which the wrapper holds its ctypes mirror to.
extern "C" int general_dyn_bytes() { return static_cast<int>(sizeof(DynFields)); }

// K4 under a dynamical action: as general_frames, plus dyn, the host
// DynFields (lateral speed and yaw rate in and out, the RK4's factors).
extern "C" int general_frames_dynamical(void* const* ptrs, const float* lane_f,
                                        const int* lane_i, const GenParams* params, int B,
                                        void* stream, const DynFields* dyn) {
  return launch<false, false, GEN_LAYOUT>(ptrs, RegFields{}, lane_f, lane_i, nullptr, nullptr,
                                        params, B, stream, dyn);
}

// K5 under a dynamical action: as general_frames_regulated, plus dyn.
extern "C" int general_frames_regulated_dynamical(void* const* ptrs, void* const* reg_ptrs,
                                                  const float* lane_f, const int* lane_i,
                                                  const GenParams* params, int B, void* stream,
                                                  const DynFields* dyn) {
  RegFields rf;
  memcpy(&rf, reg_ptrs, sizeof(RegFields));
  return launch<true, false, GEN_LAYOUT>(ptrs, rf, lane_f, lane_i, nullptr, nullptr, params, B,
                                       stream, dyn);
}

// The connected-lane search's K4 under a dynamical action: as
// general_frames_connected, plus dyn.
extern "C" int general_frames_connected_dynamical(void* const* ptrs, const float* lane_f,
                                                  const int* lane_i, const int* conn_lanes,
                                                  const float* conn_offsets,
                                                  const GenParams* params, int B, void* stream,
                                                  const DynFields* dyn) {
  return launch<false, true, GEN_LAYOUT>(ptrs, RegFields{}, lane_f, lane_i, conn_lanes,
                                       conn_offsets, params, B, stream, dyn);
}

// The connected-lane search's K5 under a dynamical action: as
// general_frames_regulated_connected, plus dyn.
extern "C" int general_frames_regulated_connected_dynamical(
    void* const* ptrs, void* const* reg_ptrs, const float* lane_f, const int* lane_i,
    const int* conn_lanes, const float* conn_offsets, const GenParams* params, int B,
    void* stream, const DynFields* dyn) {
  RegFields rf;
  memcpy(&rf, reg_ptrs, sizeof(RegFields));
  return launch<true, true, GEN_LAYOUT>(ptrs, rf, lane_f, lane_i, conn_lanes, conn_offsets, params,
                                      B, stream, dyn);
}

#if defined(GEN_CLUSTER_LIBRARY) || defined(GEN_GLOBAL_LIBRARY)
// How many clusters of `ranks` blocks of `threads` threads (the cluster
// library's 128; the global library's 128, 256 or 512) of one cluster or
// global instantiation the current card holds at once, each block asking
// the shared memory a launch asks at L lanes, R route slots, S successor
// edges and K candidates a lane (written to *smem; 0 in the global
// library): the question launch asks before a cluster launch, with the same
// attributes set first (the shared-memory size over 48 KB, the
// non-portable cluster size over GEN_PORTABLE_CLUSTER blocks).
template <bool kRegulated, bool kConnected, typename... Dyn>
static int cluster_fit(int linear, int ranks, int threads, int L, int R, int S, int K,
                       int* smem, int* clusters) {
  constexpr bool kDynamical = sizeof...(Dyn) > 0;
  constexpr bool kSized = GEN_SIZED;
  constexpr bool kGlobal = GEN_GLOBAL;
  const bool threads_ok = kGlobal ? (threads == GEN_WIDE_BLOCK || threads == 2 * GEN_WIDE_BLOCK ||
                                     threads == GEN_GLOBAL_THREADS)
                                  : threads == GEN_WIDE_BLOCK;
  if (ranks < 1 || ranks > GEN_CLUSTER_BLOCKS || !threads_ok || L < 1 || R < 1 || S < 0 ||
      (kConnected ? K < 1 : K != 0) || !smem || !clusters)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel =
      kernel_of<kRegulated, kConnected, kDynamical, true, true, kGlobal, kSized, Dyn...>(
          linear != 0);
  const size_t bytes = launch_smem<kRegulated, kConnected, true, true, kGlobal, kSized>(
      L, ranks * GEN_WIDE_SLOTS, R, S, K);
  *smem = static_cast<int>(bytes);
  // the shared-memory size only ever raised, so that no launch finds it
  // below what it set before
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess && bytes > 48 * 1024 &&
      static_cast<int>(bytes) > fa.maxDynamicSharedSizeBytes)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (e == cudaSuccess && ranks > GEN_PORTABLE_CLUSTER)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(ranks, 1, bytes, 0, &attr, threads);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg));
}

// cluster_fit of the instantiation the flags name (regulated, connected,
// dynamical, linear as 0 / 1; the kSized library's instantiation whatever
// linear says, at the scene's S and K, the fixed library's at the fixed
// layout's); returns the CUDA error code.
extern "C" int general_cluster_fit(int regulated, int connected, int dynamical, int linear,
                                   int ranks, int threads, int L, int R, int S, int K,
                                   int* smem, int* clusters) {
  using Fit = int (*)(int, int, int, int, int, int, int, int*, int*);
  static const Fit fits[8] = {
      cluster_fit<false, false>, cluster_fit<false, false, DynFields>,
      cluster_fit<false, true>,  cluster_fit<false, true, DynFields>,
      cluster_fit<true, false>,  cluster_fit<true, false, DynFields>,
      cluster_fit<true, true>,   cluster_fit<true, true, DynFields>};
  return fits[4 * (regulated != 0) + 2 * (connected != 0) + (dynamical != 0)](
      linear, ranks, threads, L, R, S, K, smem, clusters);
}
#endif

#if defined(GEN_GLOBAL_LIBRARY)
// The words (floats) of one env's slab at a scene of V slots, L lanes and R
// route slots, regulated or not (global_words): what the wrapper allocates
// an env, and what ops/general_frames.py::global_words is held to.
extern "C" long long general_global_words(int regulated, int L, int V, int R) {
  return global_words(regulated != 0, L, V, R);
}
#endif
