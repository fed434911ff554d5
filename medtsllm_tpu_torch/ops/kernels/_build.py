"""Build and bind the hand-written Hopper kernels under ``csrc/``.

Every ``medtsllm_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` at first
use (one ``nvcc`` per source, all started together) and linked into ONE
shared library with a plain C interface, named by a hash of the sources and
the flags, under ``build/medtsllm_tpu_torch/`` at the repo root, and loaded
with ``ctypes``. Each C entry point launches on the stream
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
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "medtsllm_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the entry points (csrc/*.cu); pointers and the stream are
# c_void_p so ctypes never truncates them to 32 bits
SIGNATURES = {
    # x, x_is_bf16, xq, x_scale, M, K, R, S, unit, warps, groups, stream
    "mt_act_quant_rows": (_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # g, g_is_bf16, scale, gq, g_scale, M, N, ld, rows_per_scale, R, S, unit,
    # warps, groups, stream
    "mt_grad_quant_rows": (_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # xq, wq_t, x_scale, w_scale, out, out_kind, M, N, K, stream
    "mt_w8a8_gemm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # xq, packed, x_scale, w_scale, out, out_kind, M, N, K, stream
    "mt_w4a8_gemm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # q, k, v, cos, sin, pk, pv, out, k_rot, is_bf16, B, L, H, KV, D, P, PB,
    # ldq, ldk, ldv, sm_scale, stream
    "mt_rope_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _I, _I, _F, _P),
    # q, k, v, out, is_bf16, causal, B, H, KV, L, S, D, sm_scale, stream
    "mt_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    # k, v, cos, sin, pk, pv, kc, vc, is_bf16, B, L, KV, D, P, PB, stream
    "mt_flash_keys": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # q, kc, vc, cos, sin, out, q_rot, is_bf16, B, L, H, KV, D, S, sm_scale,
    # stream
    "mt_rope_flash_attention": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _I, _F, _P),
    # q, k, v, out, part, part_ml, B, L, H, E, S, scale, stream
    "mt_reprogramming_attention": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _F, _P),
    # rows, heads, keys -> the split count of that launch (host only, no stream)
    "mt_reprogramming_splits": (_I, _I, _I),
    # dt, x, z, Bs, Cs, A, D, h0, h0_batched, y, h_final, hb, chunk, B, L, E,
    # N, ld_dt, ld_x, ld_z, ld_bc, is_bf16, params_bf16, stream
    "mt_selective_scan": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I,
                          _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # state size -> the groups a channel's states are split over (host
    # only, no stream)
    "mt_selective_scan_groups": (_I,),
    # dt, x, Bs, Cs, A_T, g, hb, ddt, dx, dB_slab, dC_slab, dA_slab, n_slabs,
    # chunk, B, L, E, N, stream
    "mt_selective_scan_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _P),
    # channels, state size -> the dB / dC slab count of that launch (host
    # only, no stream)
    "mt_selective_scan_bwd_slabs": (_I, _I),
    # xq, x_scale, n_chunks, w0, w1, ws0, ws1, visit_e, visit_valid, out0,
    # out1, out_kind, fuse_silu, V, block_m, E, N, K, w_bits, group_m, stream
    "mt_gmm": (_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
               _I, _I, _I, _I, _P),
    # t, q, q_scale, R_pad, N, block_n, stream
    "mt_gmm_requant": (_P, _P, _P, _I, _I, _I, _P),
    # block, row tiles, column tiles, group_m -> the block's tile (host only,
    # no stream)
    "mt_gmm_tile_map": (_I, _I, _I, _I),
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


def _run(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise with every failure's output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)) for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile the library unless a build of these exact sources exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = []
        compiles = []
        for src in sorted(CSRC.glob("*.cu")):
            objs.append(str(Path(tmp) / f"{src.stem}.o"))
            compiles.append([nvcc, *NVCC_FLAGS, "-c", "-o", objs[-1], str(src)])
        _run(compiles)
        lib = Path(tmp) / so.name
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *objs]])
        os.replace(lib, so)  # atomic: a concurrent loader never sees half a file
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


def op_outputs(outs, *inputs):
    """An op's CPU kernel's results (a tensor or a sequence of them) made
    contiguous, as its fake kernel describes them, with any that shares
    memory with an input or an earlier result copied: a custom op may
    return no alias. Copies keep the values bit for bit."""
    seen = {t.untyped_storage().data_ptr() for t in _tensors(inputs) if t.numel()}
    single = isinstance(outs, torch.Tensor)
    res = []
    for t in [outs] if single else outs:
        t = t.contiguous()
        key = t.untyped_storage().data_ptr()
        if t.numel() and key in seen:
            t = t.clone()
            key = t.untyped_storage().data_ptr()
        seen.add(key)
        res.append(t)
    return res[0] if single else res


def _tensors(items):
    for t in items:
        if isinstance(t, torch.Tensor):
            yield t
        elif isinstance(t, (list, tuple)):
            yield from _tensors(t)


def wants_grad(*tensors) -> bool:
    """Whether autograd would record an op on these tensors: a CPU call
    that does takes the plain version, which differentiates (the ops have
    no backward of their own)."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in _tensors(tensors))


def check_aligned(tensors, message: str) -> None:
    """Raise ``message`` unless every given tensor starts on a 16-byte
    boundary. Read in an op's CUDA kernel, on real tensors: a traced
    (fake) tensor has no address."""
    if any(t.data_ptr() % 16 for t in tensors if t is not None):
        raise ValueError(message)


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    """A tensor's device pointer; NULL for an absent optional operand."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def check_cuda(*tensors: torch.Tensor, names: str = "") -> None:
    """The kernels take contiguous tensors on one CUDA device. ``names``
    (space-separated, one a tensor) name the operands in the error."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {dev}")
    labels = names.split() or [f"operand {i}" for i in range(len(tensors))]
    for t, name in zip(tensors, labels):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}: the kernel takes "
                             "tensors on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} {tuple(t.shape)} with strides {t.stride()} is not "
                             "contiguous: the kernel reads it as dense rows")


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
