// Host Adam/AdamW for ZeRO-Offload: the port's copy of the JAX package's
// csrc/cpu_adam.cpp.
//
// The fp32 master, the gradients and both moments live in host memory; one
// OpenMP-parallel, compiler-vectorized pass updates them. Built by
// deepspeed_tpu_torch/kernels/build.py (build_host) with g++ -O3
// -march=native -fopenmp -fPIC -shared -fno-math-errno -ffp-contract=off
// into a plain C shared library loaded with ctypes, which releases the GIL
// for the call. The loops vectorize only with -fno-math-errno (a sqrtf that
// may set errno keeps them scalar) and `omp simd`, which states that the
// arrays do not overlap (the out-of-place and bf16 loops stay scalar
// without it); a vector lane rounds each operation as a scalar does.
// -ffp-contract=off keeps every multiply and add rounded on its own, so the
// plain PyTorch version (ops/adam/cpu_adam.py: cpu_adam_reference) doing the
// same operations in the same order agrees bit for bit.

#include <cmath>
#include <cstdint>

namespace {

struct AdamScalars {
    float one_m_b1, one_m_b2, inv_bc1, sqrt_bc2;
};

inline AdamScalars adam_scalars(float beta1, float beta2, int step, int bias_correction) {
    float bc1 = 1.0f, bc2 = 1.0f;
    if (bias_correction) {
        bc1 = 1.0f - powf(beta1, (float)step);
        bc2 = 1.0f - powf(beta2, (float)step);
    }
    return {1.0f - beta1, 1.0f - beta2, 1.0f / bc1, sqrtf(bc2)};
}

// The updated parameter of one element; writes the moments back.
inline float adam_element(float p, float g, float* exp_avg, float* exp_avg_sq,
                          const AdamScalars& s, float lr, float beta1, float beta2,
                          float eps, float weight_decay, int adamw) {
    if (!adamw && weight_decay != 0.0f) g += weight_decay * p;
    float m = beta1 * *exp_avg + s.one_m_b1 * g;
    float v = beta2 * *exp_avg_sq + s.one_m_b2 * g * g;
    *exp_avg = m;
    *exp_avg_sq = v;
    float denom = sqrtf(v) / s.sqrt_bc2 + eps;
    float update = (m * s.inv_bc1) / denom;
    if (adamw && weight_decay != 0.0f) update += weight_decay * p;
    return p - lr * update;
}

}  // namespace

extern "C" {

// One Adam/AdamW step over n contiguous fp32 elements, in place.
// adamw != 0 -> decoupled weight decay (AdamW); else L2 into the gradient.
void ds_adam_step(float* param, const float* grad, float* exp_avg, float* exp_avg_sq,
                  int64_t n, float lr, float beta1, float beta2, float eps,
                  float weight_decay, int adamw, int step, int bias_correction) {
    const AdamScalars s = adam_scalars(beta1, beta2, step, bias_correction);
#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i)
        param[i] = adam_element(param[i], grad[i], exp_avg + i, exp_avg_sq + i, s, lr,
                                beta1, beta2, eps, weight_decay, adamw);
}

// Out of place: the same arithmetic, the updated parameters land in
// param_out and param is left as it was. The streamed offload step
// alternates two masters this way, so the buffer an H2D copy reads from is
// not rewritten by the next step.
void ds_adam_step_out(const float* param, float* param_out, const float* grad,
                      float* exp_avg, float* exp_avg_sq, int64_t n, float lr,
                      float beta1, float beta2, float eps, float weight_decay,
                      int adamw, int step, int bias_correction) {
    const AdamScalars s = adam_scalars(beta1, beta2, step, bias_correction);
#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i)
        param_out[i] = adam_element(param[i], grad[i], exp_avg + i, exp_avg_sq + i, s, lr,
                                    beta1, beta2, eps, weight_decay, adamw);
}

// In place, and the updated parameters also cast to bf16 (uint16 bits,
// rounded to nearest even as torch's cast does; NaN stays NaN) into
// out_bf16: the staging buffer of the bf16 H2D copy, filled in the same pass.
void ds_adam_step_copy_bf16(float* param, const float* grad, float* exp_avg, float* exp_avg_sq,
                            uint16_t* out_bf16, int64_t n, float lr, float beta1, float beta2,
                            float eps, float weight_decay, int adamw, int step,
                            int bias_correction) {
    const AdamScalars s = adam_scalars(beta1, beta2, step, bias_correction);
#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float p = adam_element(param[i], grad[i], exp_avg + i, exp_avg_sq + i, s, lr,
                               beta1, beta2, eps, weight_decay, adamw);
        param[i] = p;
        uint32_t bits;
        __builtin_memcpy(&bits, &p, 4);
        uint32_t rounded = bits + 0x7FFF + ((bits >> 16) & 1);
        out_bf16[i] = p != p ? (uint16_t)0x7FC0 : (uint16_t)(rounded >> 16);
    }
}

}  // extern "C"
