// The stable s-rank permutation of a policy step's vehicle rows (K2a) and
// its inverse (K2b), one thread block per env of up to 1024 threads, each
// looping over its slots q, q + blockDim.x, ... (one slot a thread up to
// 1024 slots; up to 8192 slots, the straight path's cap).
//
// Replaces the TPU kernels highwayenv_tpu/ops/straight_pallas_bm.py::
// build_sort_kernels: sort_kernel (:1241-1255) and unsort_kernel
// (:1257-1264), both launched by the pallas_call at :1272.  Semantics are
// those of ops/straight_sorted.py::sort_plain / unsort_plain:
//
//   K2a: s = (px - ox) ux + (py - oy) uy; the rank of slot q is the count of
//        slots c with s_c < s_q, or s_c == s_q and c < q (ascending s, ties
//        by slot, -0.0 equal to 0.0); every field row moves to its rank,
//        and idx[rank] = q;
//   K2b: the row at rank r moves back to slot idx[r].
//
// Both are pure permutations and bit-exact.  What bounds them on an H100:
// bytes.  K2a moves ~97 bytes a slot each way (B = 4096, V = 51: ~41 MB),
// against B V^2 ~ 1e7 comparisons for the ranks; K2b moves the 11 mutated
// fields.  What the design does about it: one pass over each field, the
// env's s staged once in shared memory for the rank count (32 KB at 8192
// slots, so no cluster is needed), and the field list passed by value so
// one kernel moves every field of any width.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_FIELDS 32
// Most slots of an env: its s, staged in shared memory, takes 32 KB.
#define SORT_MAX_SLOTS 8192

// The fields one launch permutes: (B, V) rows of 1, 4, 8 or 12 bytes a slot.
struct Perm {
  const void* in[MAX_FIELDS];
  void* out[MAX_FIELDS];
  int bytes[MAX_FIELDS];
  int n;
};

__device__ __forceinline__ void move_row(const Perm& p, size_t from, size_t to) {
  for (int k = 0; k < p.n; ++k) {
    switch (p.bytes[k]) {
      case 1:
        static_cast<uint8_t*>(p.out[k])[to] = static_cast<const uint8_t*>(p.in[k])[from];
        break;
      case 4:
        static_cast<uint32_t*>(p.out[k])[to] = static_cast<const uint32_t*>(p.in[k])[from];
        break;
      case 12: {  // a float triple
        const uint32_t* in = static_cast<const uint32_t*>(p.in[k]) + 3 * from;
        uint32_t* out = static_cast<uint32_t*>(p.out[k]) + 3 * to;
        out[0] = in[0];
        out[1] = in[1];
        out[2] = in[2];
        break;
      }
      default:  // 8: a float pair
        static_cast<uint2*>(p.out[k])[to] = static_cast<const uint2*>(p.in[k])[from];
        break;
    }
  }
}

__global__ void sort_kernel(Perm p, const float* pos, int* idx, float ox,
                            float oy, float ux, float uy, int V) {
  extern __shared__ float s_env[];
  const size_t base = static_cast<size_t>(blockIdx.x) * V;
  for (int q = threadIdx.x; q < V; q += blockDim.x) {
    const size_t o = base + q;
    s_env[q] = (pos[2 * o] - ox) * ux + (pos[2 * o + 1] - oy) * uy;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < V; q += blockDim.x) {
    const float s = s_env[q];
    int rank = 0;
    for (int c = 0; c < V; ++c) {
      const float sc = s_env[c];
      rank += (sc < s || (sc == s && c < q)) ? 1 : 0;
    }
    move_row(p, base + q, base + rank);
    idx[base + rank] = q;
  }
}

__global__ void unsort_kernel(Perm p, const int* idx, int V) {
  const size_t base = static_cast<size_t>(blockIdx.x) * V;
  for (int r = threadIdx.x; r < V; r += blockDim.x) {
    move_row(p, base + r, base + idx[base + r]);
  }
}

// Threads of a launch's block: V rounded up to a warp, at most 1024.
static int sort_threads(int V) { return V >= 1024 ? 1024 : ((V + 31) / 32) * 32; }

static int make_perm(Perm* p, const void* const* ins, void* const* outs,
                     const int* bytes, int n) {
  if (n < 0 || n > MAX_FIELDS) return static_cast<int>(cudaErrorInvalidValue);
  p->n = n;
  for (int k = 0; k < n; ++k) {
    p->in[k] = ins[k];
    p->out[k] = outs[k];
    p->bytes[k] = bytes[k];
  }
  return 0;
}

extern "C" int straight_sort(const void* const* ins, void* const* outs,
                             const int* bytes, int n, const float* pos,
                             int* idx, float ox, float oy, float ux, float uy,
                             int B, int V, void* stream) {
  Perm p;
  const int err = make_perm(&p, ins, outs, bytes, n);
  if (err != 0) return err;
  if (V > SORT_MAX_SLOTS) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && V > 0) {
    sort_kernel<<<B, sort_threads(V), V * sizeof(float),
                  static_cast<cudaStream_t>(stream)>>>(p, pos, idx, ox, oy, ux,
                                                       uy, V);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int straight_unsort(const void* const* ins, void* const* outs,
                               const int* bytes, int n, const int* idx, int B,
                               int V, void* stream) {
  Perm p;
  const int err = make_perm(&p, ins, outs, bytes, n);
  if (err != 0) return err;
  if (V > SORT_MAX_SLOTS) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && V > 0) {
    unsort_kernel<<<B, sort_threads(V), 0, static_cast<cudaStream_t>(stream)>>>(p, idx, V);
  }
  return static_cast<int>(cudaGetLastError());
}
