"""Builds and loads the port's CUDA kernels: the counterpart of
``deepspeed_tpu/ops/op_builder.py``.

At first use every ``deepspeed_tpu_torch/csrc/*.cu`` is compiled for
Hopper (``sm_90a``) by ``nvcc``, one process per source started
together, and linked into one shared library with a plain C interface,
which is loaded with ``ctypes``. The library lands under
``build/torch_kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of the sources, so an edited source is
never served by a stale build. A build failure raises: there is no
fallback. ``-Xptxas -v`` makes ``nvcc`` print each kernel's registers,
shared memory and spills; what it printed is kept in ``nvcc.log`` beside
the library.

The host Adam of ZeRO-Offload (``csrc/cpu_adam.cpp``) is a library of its
own, built by ``build_host`` with ``g++`` (OpenMP, the build machine's
vector units) and loaded by ``load_host_library``; neither needs ``nvcc``
or a card. It is named by a hash of its source, its flags and the CPU's
model and features, and a missing ``g++`` or a refused source raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
# argtypes of every C entry: pointers and the stream as c_void_p (a plain
# int would be cut to 32 bits), every entry returns cudaGetLastError()
_SIGNATURES = {
    # q pages_k pages_v tables qpos k_scale v_scale out part_acc part_ml |
    # B C nh hd pt mp pages_per_split q_dtype kv_dtype prefill | scale stream
    "ds_decode_attend": [_P] * 10 + [_I] * 10 + [_F, _P],
    "ds_band_attend": [_P] * 8 + [_I] * 6 + [_F, _P],
    # q k v bias lut counts out lse | B H S D block maxn causal dtype |
    # scale seed threshold keep_scale dropout stream
    "ds_flash_fwd": [_P] * 8 + [_I] * 8 + [_F, _U, _U, _F, _I, _P],
    # q k v bias dout lse delta lut counts dq | ... as above
    "ds_flash_bwd_dq": [_P] * 10 + [_I] * 8 + [_F, _U, _U, _F, _I, _P],
    # q k v bias dout lse delta qlut qcounts dk dv db | ... as above
    "ds_flash_bwd_dkv": [_P] * 12 + [_I] * 8 + [_F, _U, _U, _F, _I, _P],
}

HOST_SOURCE = _CSRC / "cpu_adam.cpp"
# -fno-math-errno: sqrtf need not set errno, so the loops can vectorize
# (csrc/cpu_adam.cpp); -ffp-contract=off: no multiply and add fuse
HOST_FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-shared", "-fno-math-errno",
              "-ffp-contract=off")
_HOST_SIGNATURES = {
    # param grad exp_avg exp_avg_sq | n | lr beta1 beta2 eps weight_decay |
    # adamw step bias_correction
    "ds_adam_step": [_P] * 4 + [ctypes.c_int64] + [_F] * 5 + [_I] * 3,
    # param param_out grad exp_avg exp_avg_sq | ... as above
    "ds_adam_step_out": [_P] * 5 + [ctypes.c_int64] + [_F] * 5 + [_I] * 3,
    # param grad exp_avg exp_avg_sq out_bf16 | ... as above
    "ds_adam_step_copy_bf16": [_P] * 5 + [ctypes.c_int64] + [_F] * 5 + [_I] * 3,
}

_lock = threading.Lock()
_lib = None
_host_libs = {}
build_seconds = None


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def sources():
    return sorted(_CSRC.glob("*.cu"))


def _digest():
    h = hashlib.sha256()
    for f in sorted(_CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build():
    """Compile the sources into the library (if not already built) and
    return its path."""
    global build_seconds
    lib_path = BUILD_DIR / f"libdstorch_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}_{lib_path.stem[-16:]}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures, log = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} ({time.perf_counter() - t0:.1f} s)\n{out}")
        if proc.returncode != 0:
            failures.append(f"{src.name}:\n{out}")
    (BUILD_DIR / "nvcc.log").write_text("\n".join(log))
    if failures:
        raise KernelBuildError("nvcc failed\n" + "\n".join(failures))
    tmp = lib_path.with_suffix(f".tmp{os.getpid()}")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs),
         "-lcudart"], capture_output=True, text=True)
    if link.returncode != 0:
        raise KernelBuildError(f"link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib_path)
    build_seconds = time.perf_counter() - t0
    return lib_path


def load_library():
    """The loaded kernel library, built at first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ds_error_string.argtypes = [_I]
            lib.ds_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc, name):
    """Raise if a C entry reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = load_library().ds_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} at launch ({msg})")


def _cpu_features():
    """The host CPU's model and feature flags, as the kernel's name must
    change with them (empty where /proc/cpuinfo is missing)."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return b""
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))][:2]
    return "\n".join(keep).encode()


def build_host(flags=HOST_FLAGS):
    """Compile the host Adam with ``g++`` (if not already built with these
    flags) and return the library's path."""
    h = hashlib.sha256(HOST_SOURCE.read_bytes())
    h.update(" ".join(flags).encode())
    h.update(_cpu_features())   # -march=native: a build fits only its own CPU
    lib_path = BUILD_DIR / f"libdstorch_host_{h.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    gxx = shutil.which("g++")
    if gxx is None:
        raise KernelBuildError("g++ not found: the host Adam cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".tmp{os.getpid()}")
    out = subprocess.run([gxx, *flags, str(HOST_SOURCE), "-o", str(tmp)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise KernelBuildError(f"g++ failed:\n{out.stdout}{out.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def load_host_library(flags=HOST_FLAGS):
    """The loaded host Adam library, built at first call. ``ctypes``
    releases the GIL for the length of each call."""
    with _lock:
        if flags not in _host_libs:
            lib = ctypes.CDLL(str(build_host(flags)))
            for name, argtypes in _HOST_SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = None
            _host_libs[flags] = lib
        return _host_libs[flags]
