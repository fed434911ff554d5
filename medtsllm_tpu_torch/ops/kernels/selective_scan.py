"""K7/K8: the selective-SSM scan of the Mamba block
(``csrc/selective_scan.cu``) and its plain version.

Replaces ``medtsllm_tpu/ops/pallas/selective_scan.py``: ``selective_ssm``
(``_ssm_pallas``, the scan from h = 0), ``selective_ssm_h0``
(``_ssm_pallas_h0``, the scan resumed from a cached prefix state) and the
prefill form ``selective_ssm_final`` (XLA in the JAX package), with the
same signatures and all operands f32:

    dt, xs [B, L, E]; A_T [N, E]; Bs, Cs [B, L, N]; D [E]; h0 [1 or B, N, E]
    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t;  y_t = C_t . h_t + D x_t

One CUDA entry point serves all three: h0 and the final state are optional
operands. Each wrapper counts its own launches (``.launches``), so a run
can tell the uncached scan, the cached scan and the prefill apart.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from . import _build

STATE_SIZES = (4, 8, 16)  # the kernel's instances of N


def selective_ssm_final_plain(dt, A_T, Bs, Cs, xs, D, h0=None):
    """(y [B, L, E], h_final [B, N, E]): a loop over L on the [B, N, E]
    state."""
    B, L, E = dt.shape
    N = A_T.shape[0]
    h = (torch.zeros(B, N, E, dtype=torch.float32, device=dt.device)
         if h0 is None else h0.float().expand(B, N, E))
    ys = []
    for t in range(L):
        dA = torch.exp(dt[:, t, None, :] * A_T[None])
        dBx = (dt[:, t] * xs[:, t])[:, None, :] * Bs[:, t, :, None]
        h = dA * h + dBx
        ys.append((h * Cs[:, t, :, None]).sum(dim=1))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(dt)
    return y + D * xs, h.contiguous()


def selective_ssm_plain(dt, A_T, Bs, Cs, xs, D, h0=None):
    return selective_ssm_final_plain(dt, A_T, Bs, Cs, xs, D, h0)[0]


def _scan(dt, A_T, Bs, Cs, xs, D, h0, final: bool):
    """Check the operands and launch the kernel; returns (y, h_final or
    None)."""
    B, L, E = dt.shape
    N = A_T.shape[0]
    if N not in STATE_SIZES:
        raise ValueError(f"state size {N} not supported {STATE_SIZES}")
    if (xs.shape != dt.shape or A_T.shape != (N, E) or Bs.shape != (B, L, N)
            or Cs.shape != Bs.shape or D.shape != (E,)):
        raise ValueError(f"dt {tuple(dt.shape)} A_T {tuple(A_T.shape)} Bs "
                         f"{tuple(Bs.shape)} Cs {tuple(Cs.shape)} xs "
                         f"{tuple(xs.shape)} D {tuple(D.shape)}")
    tensors = [dt, A_T, Bs, Cs, xs, D]
    if h0 is not None:
        if h0.dim() != 3 or h0.shape[0] not in (1, B) or h0.shape[1:] != (N, E):
            raise ValueError(f"h0 must be [1 or {B}, {N}, {E}], got {tuple(h0.shape)}")
        tensors.append(h0)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"the scan takes f32 operands, got {[t.dtype for t in tensors]}")
    _build.check_cuda(*tensors)
    y = torch.empty_like(dt)
    h_final = torch.empty(B, N, E, dtype=torch.float32, device=dt.device) if final else None
    ptr = _build.ptr
    _build.launch("mt_selective_scan", dt.device, ptr(dt), ptr(xs), ptr(Bs), ptr(Cs),
                  ptr(A_T), ptr(D), ptr(h0), int(h0 is not None and h0.shape[0] > 1),
                  ptr(y), ptr(h_final), B, L, E, N)
    return y, h_final


def selective_ssm(dt, A_T, Bs, Cs, xs, D):
    """The scan from h = 0 -> y [B, L, E]. Counts CUDA launches in
    ``selective_ssm.launches``."""
    if dt.device.type == "cpu":
        return selective_ssm_plain(dt, A_T, Bs, Cs, xs, D)
    y, _ = _scan(dt, A_T, Bs, Cs, xs, D, None, final=False)
    selective_ssm.launches += 1
    return y


def selective_ssm_h0(dt, A_T, Bs, Cs, xs, D, h0):
    """The scan resumed from h0 [1 or B, N, E] -> y [B, L, E]. Counts CUDA
    launches in ``selective_ssm_h0.launches``."""
    if dt.device.type == "cpu":
        return selective_ssm_plain(dt, A_T, Bs, Cs, xs, D, h0)
    y, _ = _scan(dt, A_T, Bs, Cs, xs, D, h0, final=False)
    selective_ssm_h0.launches += 1
    return y


def selective_ssm_final(dt, A_T, Bs, Cs, xs, D, h0=None):
    """The prefill form -> (y [B, L, E], h_final [B, N, E]). Counts CUDA
    launches in ``selective_ssm_final.launches``."""
    if dt.device.type == "cpu":
        return selective_ssm_final_plain(dt, A_T, Bs, Cs, xs, D, h0)
    out = _scan(dt, A_T, Bs, Cs, xs, D, h0, final=True)
    selective_ssm_final.launches += 1
    return out


selective_ssm.launches = 0
selective_ssm_h0.launches = 0
selective_ssm_final.launches = 0
