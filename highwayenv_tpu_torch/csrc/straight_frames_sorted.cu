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
//   neighbours: the members of the query lane at ranks r-Wn..r+Wn, in
//     ascending rank with the dense predicates (front `<=`: the larger rank
//     wins ties; rear strict `>`: the smaller rank wins), plus, per lane,
//     the winner beyond the band: the suffix argmin of s over ranks > r+Wn
//     (ties to the larger rank) and the prefix argmax over ranks < r-Wn
//     (ties to the smaller rank).  A far member that crossed the query in s
//     since the sort raises the neighbour flag, on rows that consume the
//     result (the own lane for uncrashed IDM rows, lanes -1 / +1 for
//     deciding or mid-change rows).
//   collisions: the swept SAT on the pairs at rank distance 1..W behind the
//     dense pass's gate and sphere pre-check, the lower rank as the SAT's
//     first rectangle, reach with the speed of the lower original slot, and
//     the last-write impact as a max over the partner's original slot, the
//     row side (this slot is the pair's `self`, the lower original slot)
//     beating the column side.  The collision flag rises where an active
//     rank beyond r+W could be within R = max diag + max speed * dt of the
//     rank's s (suffix min / max of s; R over this env's active slots).
//
// Each flag is sticky over the frames and written once per env (flags[2b]
// collision, flags[2b+1] neighbour); the caller re-runs a flagged env
// through the dense kernel, so the accepted result is always exact.
//
// What bounds it on an H100: as the dense kernel, issue slots and the
// latency of dependent shared-memory loads, not float operations (~1.8e9 a
// highway-v0 step at B = 4096) or bytes.  On the earlier design, which ran
// each scan as ceil(log2 V) rounds in shared memory with a block barrier
// each and re-read s through the winner's rank, thread 0's clock64() split
// of a highway-v0 frame (V = 51, tools/kernel_ab.py --clocks) was 20% the
// far-band scans, 21% the band search, 37.5% drive(), 3% the collision
// scans, 13.5% the collision band, 61k cycles a frame at 105 registers, and
// the kernel was slower than the dense one.  What this design does about
// it: every scan runs inside a warp on registers, (s, rank) packed into
// one 64-bit key (float_order) so that __shfl_down_sync / __shfl_up_sync
// and a plain min / max carry the plain version's tie rule; each thread
// stores its inclusive in-warp result, one barrier publishes them, and a
// query joins the result at its position with the warp totals beyond it
// (lane 0, or 31, of each later, or earlier, warp).  The env's max diag
// and speed are one warp reduction each.  The band searches walk the set
// bits of the lane and gate words within the band, ascending; each pair's
// sphere pre-check runs once, at its lower rank, which publishes a W-bit
// mask for the other member behind one more barrier (three a frame).  The
// rest is the dense kernel's.  At V = 51 the two kernels take about the
// same time: the dense walks of ~13 members a lane cost what the banded
// walks and the scans cost; from V = 101 on the sorted kernel is faster.

#include "straight_common.cuh"
#include "straight_global.cuh"

// The order of s as an unsigned: a < b as floats, with -0 equal to 0, iff
// float_order(a) < float_order(b).  A far-band scan packs it with ~rank
// into one 64-bit key, so a plain min (suffix argmin, ties to the larger
// rank) or max (prefix argmax, ties to the smaller rank) is the plain
// version's tie rule, and the neutral key needs no test of its own.
__device__ __forceinline__ unsigned float_order(float s) {
  const unsigned b = __float_as_uint(s + 0.f);  // -0 + 0 = +0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The words of one env's rows at n threads (its slots rounded up to a
// warp, a block's or in the global layout the env's cluster's), L lanes and
// nb blocks: per thread the rows, the collision band's s, the far-band
// winners (two 16-bit ranks per lane) and the pre-check bits; per warp the
// ballot words and the max diag / speed; in the global layout two flag
// words per block.  The global layout's slab holds this many an env,
// rounded up to 4 (16-byte-aligned rows).
__host__ __device__ __forceinline__ long long sorted_env_words(int n, int L, int nb) {
  const long long w = static_cast<long long>(ROW_WORDS + 2 + L + 1) * n +
                      static_cast<long long>(WARP_WORDS(L) + 2) * (n / 32) + 2ll * nb;
  return (w + 3) & ~3ll;
}

// The frame loop of one env on the rank layout, its rows in the block's
// shared memory or, in the global layout (kGlobal, straight_global.cuh), in
// its slab of global memory at slab + env * sorted_env_words, the env a
// cluster of blocks.
template <bool kLinear, bool kGlobal>
__device__ __forceinline__ void frames_sorted_body(const Fields& f, const int* idx,
                                                   uint8_t* flags, const Geo& g,
                                                   const Params& p, int V, int frames, int W,
                                                   int Wn, float* slab) {
  extern __shared__ __align__(16) float smem[];
  const Place at = place<kGlobal>();
  const int N = at.n;
  const int L = g.n_lanes;
  load_lane_offsets(g);
  Rows r;
  float* rows = kGlobal ? slab + at.env * sorted_env_words(N, L, at.blocks)
                        : smem + lane_offset_words(L);
  // the in-warp suffix min / max of the active ranks' s, [N]
  float2* band_s = reinterpret_cast<float2*>(r.carve(rows, N, L));
  // each warp's max diag and max speed, [2][N / 32]
  float* warp_max = reinterpret_cast<float*>(band_s + N);
  // the in-warp far-band winners' ranks, [ahead, behind][L][N]
  short* far = reinterpret_cast<short*>(warp_max + 2 * r.nw);
  // per rank, bit d - 1: its pair with rank + d passed the sphere pre-check
  unsigned* near_up = reinterpret_cast<unsigned*>(far + 2 * L * N);
  // the view through which this block writes its warps' ballot words
  const Rows rb = kGlobal ? r.at_warp(at.warp0) : r;
#define FAR(dir, l, j) far[((dir) * L + (l)) * N + (j)]

  const int i = at.i;
  const int lane_i = i & 31;
  const bool live = i < V;
  const size_t o = static_cast<size_t>(at.env) * V + i;
  typename SlotOf<kLinear>::type v;
  if (live) v.load(f, o);
  v.derive();
  r.post[i].len = v.len;
  r.post[i].wid = v.wid;
  r.post[i].orig = live ? idx[o] : -1;
  bool viol_coll = false, viol_neigh = false;
  env_sync<kGlobal>();  // the lane offsets are loaded

  for (int frame = 0; frame < frames; ++frame) {
    const Start st = frame_start(v, g);
    stage_start(rb, i, live, v, st, g);
    // --- far-band winners per lane: in-warp suffix argmin / prefix argmax --
    const unsigned long long key =
        (static_cast<unsigned long long>(float_order(st.s)) << 32) | ~static_cast<unsigned>(i);
    for (int l = 0; l < L; ++l) {
      const bool member = lane_member(st, live, g, l);
      // ahead: a suffix min, the neutral key the largest; behind: a prefix
      // max, the neutral key 0.  A lane past the warp's end reads its own key.
      unsigned long long ka = member ? key : ~0ull, kb = member ? key : 0ull;
      if (__any_sync(FULL_MASK, member)) {
#pragma unroll
        for (int k = 1; k < 32; k *= 2) {
          ka = min(ka, __shfl_down_sync(FULL_MASK, ka, k));
          kb = max(kb, __shfl_up_sync(FULL_MASK, kb, k));
        }
      }
      FAR(0, l, i) = ka == ~0ull ? -1 : static_cast<short>(~static_cast<unsigned>(ka));
      FAR(1, l, i) = kb == 0ull ? -1 : static_cast<short>(~static_cast<unsigned>(kb));
    }
    env_sync<kGlobal>();

    if (live) {
      // --- banded neighbours on the own lane and lanes -1 / +1 -------------
      const bool idm = is_idm(v);
      const bool mid_change = v.lane != v.tlane;
      const bool deciding = idm && !mid_change && v.timer > p.lane_change_delay && v.elc;
      int front[3], rear[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int ql = clampi(query_lane(v.lane, k, L), 0, L - 1);
        // the far winners: the in-warp result at the band's edge joined
        // with the totals of the warps beyond it
        int a = -1, b = -1;
        const int pa = i + Wn + 1, pb = i - Wn - 1;
        if (pa < V) {
          a = FAR(0, ql, pa);
          for (int w = (pa >> 5) + 1; w < r.nw; ++w) {
            const int a2 = FAR(0, ql, w << 5);
            if (a2 >= 0 && (a < 0 || r.s(a2) <= r.s(a))) a = a2;
          }
        }
        if (pb >= 0) {
          b = FAR(1, ql, pb);
          for (int w = (pb >> 5) - 1; w >= 0; --w) {
            const int b2 = FAR(1, ql, (w << 5) + 31);
            if (b2 >= 0 && (b < 0 || r.s(b2) >= r.s(b))) b = b2;
          }
        }
        const float sa_ = a >= 0 ? r.s(a) : 0.f, sb_ = b >= 0 ? r.s(b) : 0.f;
        const bool crossed = (a >= 0 && sa_ < st.s) || (b >= 0 && sb_ >= st.s);
        if (crossed && (k == 0 ? idm : (deciding || mid_change))) viol_neigh = true;
        float f_key = INFINITY, r_key = -INFINITY;
        int f_idx = -1, r_idx = -1;
        if (b >= 0 && sb_ < st.s) {  // far behind first: it has the smallest ranks
          r_key = sb_;
          r_idx = b;
        }
        const unsigned* memb = r.memb(ql);
        visit_bits([&](int w) { return memb[w]; }, max(i - Wn, 0), min(i + Wn, V - 1), i,
                   [&](int col) {
                     const float sc = r.s(col);
                     if (st.s <= sc && sc <= f_key) {
                       f_key = sc;
                       f_idx = col;
                     }
                     if (sc < st.s && sc > r_key) {
                       r_key = sc;
                       r_idx = col;
                     }
                   });
        if (a >= 0 && st.s <= sa_ && sa_ <= f_key) f_idx = a;  // far ahead last
        front[k] = f_idx;
        rear[k] = r_idx;
      }
      drive(v, st, front, rear, r, i, V, g, p);
    }

    stage_post(rb, i, live, v);
    // --- collision band: in-warp suffix min / max of s, max diag and speed -
    const bool act = live && v.active();
    const float s_new = (v.px - g.ox) * g.ux + (v.py - g.oy) * g.uy;
    {
      float lo = act ? s_new : INFINITY, hi = act ? s_new : -INFINITY;
      // an inactive slot counts 0 toward the maxima, a thread without one nothing
      const float none = live ? 0.f : -INFINITY;
      float dg = act ? v.diag : none, sp = act ? v.speed : none;
#pragma unroll
      for (int k = 1; k < 32; k *= 2) {
        const float lo2 = __shfl_down_sync(FULL_MASK, lo, k);
        const float hi2 = __shfl_down_sync(FULL_MASK, hi, k);
        if (lane_i + k < 32) {
          lo = fminf(lo, lo2);
          hi = fmaxf(hi, hi2);
        }
        dg = fmaxf(dg, __shfl_xor_sync(FULL_MASK, dg, k));
        sp = fmaxf(sp, __shfl_xor_sync(FULL_MASK, sp, k));
      }
      band_s[i] = make_float2(lo, hi);
      if (lane_i == 0) {
        warp_max[i >> 5] = dg;
        warp_max[r.nw + (i >> 5)] = sp;
      }
    }
    env_sync<kGlobal>();

    // --- banded collisions: the flag, each pair's pre-check at its lower rank
    const float4 me = r.pose(i);
    const int me_orig = r.post[i].orig;
    unsigned up = 0;
    if (live) {
      const int far_r = i + W + 1;
      if (act && far_r < V) {
        float dmax = warp_max[0], smax = warp_max[r.nw];
        for (int w = 1; w < r.nw; ++w) {
          dmax = fmaxf(dmax, warp_max[w]);
          smax = fmaxf(smax, warp_max[r.nw + w]);
        }
        const float R = dmax + smax * p.dt;
        float lo = band_s[far_r].x, hi = band_s[far_r].y;
        for (int w = (far_r >> 5) + 1; w < r.nw; ++w) {
          lo = fminf(lo, band_s[w << 5].x);
          hi = fmaxf(hi, band_s[w << 5].y);
        }
        if (lo <= s_new + R && hi >= s_new - R) viol_coll = true;
      }
      // this rank is the lower of the pair: its pose is the first one, the
      // reach takes the speed of the lower original slot
      const bool ac = v.active() && v.coll;
      visit_bits([&](int w) { return gate_word(r, w, ac, v.is_vehicle(), v.chk); }, i + 1,
                 min(i + W, V - 1), i, [&](int j) {
                   const float4 other = r.pose(j);
                   const float speed_lo = me_orig < r.post[j].orig ? me.z : other.z;
                   if (within_reach(me, other, speed_lo, p)) up |= 1u << (j - i - 1);
                 });
    }
    near_up[i] = up;
    env_sync<kGlobal>();

    // --- banded collisions: the swept SATs of the pairs that passed, impacts
    if (live) {
      bool any_inter = false, any_will = false;
      int best_r = -1, best_c = -1;  // the partner's original slot
      float imp_rx = 0.f, imp_ry = 0.f, imp_cx = 0.f, imp_cy = 0.f;
      auto hit = [&](int j) {
        const int partner = r.post[j].orig;
        const bool lower = i < j;  // this rank is the SAT's first rectangle
        bool inter, will;
        float tx, ty;
        sat_pair(r, p, lower ? i : j, lower ? j : i, &inter, &will, &tx, &ty);
        any_inter = any_inter || inter;
        if (will) {
          any_will = true;
          // half the translation toward this slot: +t for the lower rank
          const float hx = 0.5f * tx, hy = 0.5f * ty;
          const float to_x = lower ? hx : -hx, to_y = lower ? hy : -hy;
          if (me_orig < partner) {
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
      };
      for (int j = max(i - W, 0); j < i; ++j) {
        if ((near_up[j] >> (i - j - 1)) & 1u) hit(j);
      }
      for (; up; up &= up - 1) hit(i + __ffs(up));
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
#undef FAR

  const int any_coll = __syncthreads_or(viol_coll);
  const int any_neigh = __syncthreads_or(viol_neigh);
  trap_on_kinds<kLinear, false>(live, v.kind);  // lean: vehicles only
  if (live) v.store(f, o);
  if constexpr (kGlobal) {
    // the env's flags: each block's two votes, joined by the env's first
    // thread after the barrier
    unsigned* votes = near_up + N;
    if (threadIdx.x == 0) {
      votes[2 * at.rank] = any_coll ? 1u : 0u;
      votes[2 * at.rank + 1] = any_neigh ? 1u : 0u;
    }
    env_sync<true>();
    if (i == 0) {
      unsigned coll = 0u, neigh = 0u;
      for (int k = 0; k < at.blocks; ++k) {
        coll |= votes[2 * k];
        neigh |= votes[2 * k + 1];
      }
      flags[2 * at.env] = coll ? 1 : 0;
      flags[2 * at.env + 1] = neigh ? 1 : 0;
    }
  } else if (i == 0) {
    flags[2 * at.env] = any_coll ? 1 : 0;
    flags[2 * at.env + 1] = any_neigh ? 1 : 0;
  }
}

template <bool kLinear>
__global__ void __launch_bounds__(MAX_BLOCK_THREADS)
    straight_frames_sorted_kernel(const __grid_constant__ Fields f, const int* idx,
                                  uint8_t* flags, const __grid_constant__ Geo g,
                                  const __grid_constant__ Params p, int V, int frames, int W,
                                  int Wn) {
  frames_sorted_body<kLinear, false>(f, idx, flags, g, p, V, frames, W, Wn, nullptr);
}

extern "C" int straight_frames_sorted(STRAIGHT_FIELD_PARAMS, const int* idx, uint8_t* flags,
                                      const Geo* geo, const Params* params, int B, int V,
                                      int frames, int W, int Wn, void* stream) {
  const Fields f = STRAIGHT_FIELDS;
  // per thread: the rows, the collision band's s, the far-band winners
  // (two 16-bit ranks per lane) and the pre-check bits; per warp: the
  // ballot words and the max diag / speed
  const int words = ROW_WORDS + 2 + geo->n_lanes + 1;
  const int warp_words = WARP_WORDS(geo->n_lanes) + 2;
  // the Linear rows' instantiation where the caller says they are possible
  auto kernel =
      params->linear ? straight_frames_sorted_kernel<true> : straight_frames_sorted_kernel<false>;
  return launch_per_env(kernel, B, V, geo->n_lanes, words, warp_words, stream, f,
                        idx, flags, *geo, *params, V, frames, W, Wn);
}

// The shared memory a block of straight_frames_sorted asks at V slots and L
// lanes (what ops/straight_frames.py::launch_smem is held to).
extern "C" long long straight_frames_sorted_smem_bytes(int V, int L) {
  return static_cast<long long>(frames_smem(V, L, ROW_WORDS + 2 + L + 1, WARP_WORDS(L) + 2));
}
