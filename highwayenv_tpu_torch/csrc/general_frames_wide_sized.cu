// The kSized library of the wide K4 and K5: general_frames.cu's entries, with
// the same names, launching the kSized instantiations (poly lanes, and the
// tables' strides read at run time) for the scenes outside the fixed
// layout; see the note there.  A library of its own, so that nvcc builds it
// beside the fixed one.
#define GEN_WIDE_LIBRARY
#define GEN_SIZED_LIBRARY
#include "general_frames.cu"
