// The wide library of K4 and K5: general_frames.cu's entries, with the same
// names, launching its wide kernels (general_frames_wide_kernel, one env a
// block of 128 threads, scenes of up to 128 slots); see the note there.
// A library of its own, so that nvcc builds it beside the narrow one.
#define GEN_WIDE_LIBRARY
#include "general_frames.cu"
