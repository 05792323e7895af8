// The head_dims past 256 (padded) of csrc/flash_decode.cu's kernels (K5,
// K6, K8, K9, K10, K16, K17c): the same source with FD_WIDE set, built as
// a library of its own so that nvcc compiles its two heavy instances (D
// up to 512, and the streamed, column-chunked one past it) beside the rest;
// ops/flash_decode.py `_source` picks it for a head_dim above 256.
#define FD_WIDE 1
#include "flash_decode.cu"
