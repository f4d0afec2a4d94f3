// The cluster library of K4 and K5: general_frames.cu's entries, with the
// same names, launching its cluster kernels (general_frames_cluster_kernel,
// one env a cluster of up to 16 blocks of 128 threads, scenes of 129 to
// 2048 slots), and general_cluster_fit, the launch's occupancy question;
// see the note there.  A library of its own, so that nvcc builds it beside
// the narrow and the wide ones.
#define GEN_CLUSTER_LIBRARY
#include "general_frames.cu"
