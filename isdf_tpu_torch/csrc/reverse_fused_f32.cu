// The reverse-fused op (reverse_fused.cu) in the f32-product mode of
// mlp_tile.cuh: every hidden product in IEEE f32, for tpu.mm_precision
// other than "default" (isdf_tpu/models/pallas_mlp.py::
// make_pallas_reverse_fused with mm_dtype = float32).
#define MLP_F32 1
#include "reverse_fused.cu"
