// The fused train op (train_mlp.cu) for a PE of up to 384 lanes (E = 381
// at n_embed_funcs 8, iSDF's live RealSense configs): layer 0 and the skip
// layer's pe rows 384 deep, the PE, m0 and d raw / d pe 384 wide, in the
// bf16-product mode (mlp_tile.cuh, MLP_LANES).
#define MLP_LANES 384
#include "train_mlp.cu"
