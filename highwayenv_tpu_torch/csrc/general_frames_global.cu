// The global library of K4 and K5: general_frames.cu's entries, with the
// same names, launching its global kernels (general_frames_global_kernel,
// one env a cluster of up to 16 blocks of 128 to 512 threads with its
// arrays in a slab of global memory, the kSized instantiations alone: the
// scenes past a block's shared memory and of 2049 to 8192 slots),
// general_cluster_fit, the launch's occupancy question, and
// general_global_words, the slab's words an env; see the note there.  A
// library of its own, so that nvcc builds it beside the others.
#define GEN_GLOBAL_LIBRARY
#include "general_frames.cu"
