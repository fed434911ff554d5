"""Build and bind the hand-written Hopper kernels under ``csrc/``.

Every ``medtsllm_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` at first
use into ONE shared library with a plain C interface, named by a hash of
the sources and the flags, under ``build/medtsllm_tpu_torch/`` at the repo
root, and loaded with ``ctypes``. Each C entry point launches on the stream
it is given, allocates nothing, and returns ``cudaGetLastError()``; the
caller raises when that is not 0. A failed build raises: nothing runs
without its kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "medtsllm_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the entry points (csrc/*.cu); pointers and the stream are
# c_void_p so ctypes never truncates them to 32 bits
SIGNATURES = {
    # x, x_is_bf16, xq, x_scale, M, K, stream
    "mt_act_quant_rows": (_P, _I, _P, _P, _I, _I, _P),
    # xq, wq_t, x_scale, w_scale, out, out_kind, M, N, K, stream
    "mt_w8a8_gemm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # q, k, v, cos, sin, pk, pv, out, is_bf16, B, L, H, KV, D, P, PB,
    # sm_scale, stream
    "mt_rope_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _I, _I, _I, _F, _P),
    # q, k, v, out, B, L, H, E, S, scale, stream
    "mt_reprogramming_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                   _P),
}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels cannot be built")
    return path


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmedtsllm_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a build of these exact sources exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.mt_error_string.argtypes = [ctypes.c_int]
    lib.mt_error_string.restype = ctypes.c_char_p
    return lib


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    """A tensor's device pointer; NULL for an absent optional operand."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def check_cuda(*tensors: torch.Tensor) -> None:
    """The kernels take contiguous tensors on one CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors on one CUDA device")


def launch(name: str, device: torch.device, *args) -> None:
    """Call one C entry point on ``device``'s current stream (passed as its
    last argument) and raise on the CUDA error it returns."""
    lib = library()
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        msg = lib.mt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
