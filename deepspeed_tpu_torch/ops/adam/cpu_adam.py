"""DeepSpeedCPUAdam: Adam on host memory for ZeRO-Offload.

Port of ``deepspeed_tpu/ops/adam/cpu_adam.py``. The host step runs the
port's C++ kernel ``csrc/cpu_adam.cpp`` (OpenMP, vectorized by ``g++``),
built at first use by ``kernels/build.py`` and called through ``ctypes``,
which releases the GIL, so the offload pipeline's worker threads step in
parallel with the training thread. There is no fallback: a missing
``g++`` or a failed build raises. ``cpu_adam_reference`` is the plain
PyTorch version of the same per-element formula, for the tests and the
chip check only.

The class is also the device-path optimizer (``init`` / ``update`` of
``FusedAdam``), so a config runs with or without offload.
"""

import ctypes

import numpy as np
import torch

from deepspeed_tpu_torch.kernels import build, registry
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam


class HostAdamState:
    __slots__ = ("step", "exp_avg", "exp_avg_sq")

    def __init__(self, n):
        self.step = 0
        self.exp_avg = torch.zeros(n, dtype=torch.float32)
        self.exp_avg_sq = torch.zeros(n, dtype=torch.float32)


def _adam_scalars(beta1, beta2, step, bias_correction):
    """(1 - beta1, 1 - beta2, 1 / bc1, sqrt(bc2)) in fp32, as the kernel
    computes them."""
    f = np.float32
    bc1 = bc2 = f(1)
    if bias_correction:
        bc1 = f(1) - f(beta1) ** f(step)
        bc2 = f(1) - f(beta2) ** f(step)
    return (float(f(1) - f(beta1)), float(f(1) - f(beta2)), float(f(1) / bc1),
            float(np.sqrt(bc2)))


def cpu_adam_reference(param, grad, exp_avg, exp_avg_sq, *, lr, beta1, beta2, eps,
                       weight_decay, adamw, step, bias_correction, param_out=None):
    """The host kernel's step in plain fp32 PyTorch ops, each rounded on
    its own, in the kernel's order: the moments in place, the updated
    parameters into ``param_out`` (``param`` when None). Returns them."""
    f = lambda x: float(np.float32(x))
    lr, beta1, beta2, eps, wd = f(lr), f(beta1), f(beta2), f(eps), f(weight_decay)
    one_m_b1, one_m_b2, inv_bc1, sqrt_bc2 = _adam_scalars(beta1, beta2, step, bias_correction)
    g = grad
    if not adamw and wd != 0.0:
        g = g + param * wd
    m = exp_avg * beta1 + g * one_m_b1
    v = exp_avg_sq * beta2 + (g * one_m_b2) * g
    exp_avg.copy_(m)
    exp_avg_sq.copy_(v)
    # sqrtf is correctly rounded; torch's vectorized fp32 sqrt on the CPU is
    # not always, so take it in fp64 and round once (exact for fp32 inputs)
    update = (m * inv_bc1) / (torch.sqrt(v.double()).float() / sqrt_bc2 + eps)
    if adamw and wd != 0.0:
        update = update + param * wd
    out = param if param_out is None else param_out
    out.copy_(param - update * lr)
    return out


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _host_f32(t, name):
    if t.device.type != "cpu" or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous fp32 CPU tensor, got "
                         f"{t.dtype} on {t.device}")
    return t


class DeepSpeedCPUAdam(FusedAdam):
    """Adam that steps on host memory (the ZeRO-Offload optimizer)."""

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, amsgrad=False, adam_w_mode=True, **kwargs):
        if kwargs.get("no_decay_names"):
            raise ValueError("no_decay_names is not supported by the host (offload) Adam: "
                             "the C++ kernel applies decay uniformly")
        super().__init__(lr=lr, bias_correction=bias_correction, betas=betas, eps=eps,
                         weight_decay=weight_decay, adam_w_mode=adam_w_mode, amsgrad=amsgrad)
        self._host_state = None

    def init_host(self, flat_master):
        self._host_state = HostAdamState(flat_master.shape[0])
        return self._host_state

    def step_host(self, master, grads, lr=None, lo=0, hi=None, advance_step=True,
                  master_out=None, out_bf16=None):
        """One Adam step of the kernel over the host fp32 master.

        ``lo`` / ``hi`` restrict it to a slice of the flat vector, so the
        offload pipeline can step a bucket at a time; ``grads`` is the whole
        vector or exactly the slice. ``advance_step=False`` keeps the step
        counter (the bias corrections) for the second and later slices of
        one step. With ``master_out`` the updated parameters land in
        ``master_out[lo:hi]`` and ``master`` is left as it was; otherwise
        the step is in place, and ``out_bf16`` (a bf16 tensor of the
        slice's length) also receives them rounded to bf16 in the same
        pass. The moments update in place either way. Stepping any set of
        disjoint slices that covers the vector equals one full step, bit
        for bit."""
        st = self._host_state
        assert st is not None, "call init_host first"
        if advance_step:
            st.step += 1
        hi = master.shape[0] if hi is None else hi
        n = hi - lo
        assert grads.shape[0] in (n, master.shape[0]), (
            f"grads must be the [lo,hi) slice ({n}) or the full vector "
            f"({master.shape[0]}), got {grads.shape[0]}")
        g = _host_f32(grads if grads.shape[0] == n else grads[lo:hi], "grads")
        p = _host_f32(master[lo:hi], "master")
        lr = float(self.lr if lr is None else lr)
        beta1, beta2 = self.betas
        common = (st.exp_avg[lo:hi], st.exp_avg_sq[lo:hi])
        scalars = (n, lr, beta1, beta2, self.eps, self.weight_decay,
                   1 if self.adam_w_mode else 0, st.step, 1 if self.bias_correction else 0)
        lib = build.load_host_library()
        if master_out is not None:
            assert out_bf16 is None, "out_bf16 goes with the in-place step"
            out = _host_f32(master_out[lo:hi], "master_out")
            lib.ds_adam_step_out(_ptr(p), _ptr(out), _ptr(g), *map(_ptr, common), *scalars)
            registry.record_launch("cpu_adam")
            return master_out
        if out_bf16 is not None:
            if out_bf16.dtype != torch.bfloat16 or out_bf16.numel() != n \
                    or not out_bf16.is_contiguous() or out_bf16.device.type != "cpu":
                raise ValueError("out_bf16 must be a contiguous bf16 CPU tensor of the "
                                 "slice's length")
            lib.ds_adam_step_copy_bf16(_ptr(p), _ptr(g), *map(_ptr, common), _ptr(out_bf16),
                                       *scalars)
        else:
            lib.ds_adam_step(_ptr(p), _ptr(g), *map(_ptr, common), *scalars)
        registry.record_launch("cpu_adam")
        return master
