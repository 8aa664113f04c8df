// The fused train op (train_mlp.cu) in the f32-product mode of
// mlp_tile.cuh: every hidden product an f32-grade product of split bf16
// parts on the tensor cores, for tpu.mm_precision other than "default"
// (isdf_tpu/models/pallas_mlp.py::make_pallas_train_op with mm_dtype =
// float32).
#define MLP_F32 1
#include "train_mlp.cu"
