// The fp16 instantiations of the three tensor-core flash-attention kernels
// (flash_attention_mma.cuh), for fp16 training with loss scaling. They
// replace the same Pallas kernels as flash_attention.cu's bf16 ones
// (deepspeed_tpu/ops/transformer/attention.py _attn_kernel :94,
// _attn_bwd_dq_kernel :204, _attn_bwd_dkv_kernel :246), which compute in
// whatever float dtype they are given. They are bound by bytes, as the bf16
// ones are (the same tiles and the same products at the same rate). They sit
// in a file of their own so that nvcc builds them beside the bf16 and fp32
// instantiations, one process a file, and not after them.

#include "flash_attention_mma.cuh"

namespace dstorch {
namespace flash {

cudaError_t dispatch_mma_f16(Kind kind, int D, const Params& P, int BH, cudaStream_t stream) {
  if (D == 32) return dispatch_mma<__half, 32>(kind, P, BH, stream);
  if (D == 64) return dispatch_mma<__half, 64>(kind, P, BH, stream);
  if (D == 128) return dispatch_mma<__half, 128>(kind, P, BH, stream);
  return cudaErrorInvalidValue;
}

}  // namespace flash
}  // namespace dstorch
