"""K7-K10: the selective-SSM scan of the Mamba block, forward
(``csrc/selective_scan.cu``) and backward (``csrc/selective_scan_bwd.cu``),
and their plain versions.

Replaces ``medtsllm_tpu/ops/pallas/selective_scan.py``: ``selective_ssm``
(``_ssm_pallas``, K7, the scan from h = 0), ``selective_ssm_h0``
(``_ssm_pallas_h0``, K8, the scan resumed from a cached prefix state), the
prefill form ``selective_ssm_final`` (XLA in the JAX package), and the
training pair behind the two ``custom_vjp``s: ``selective_ssm_bounds``
(``_ssm_pallas_with_bounds``, K9, the forward that also records the
chunk-start states) and ``selective_ssm_bwd`` (``_ssm_pallas_bwd``, K10, the
reverse adjoint). Same signatures and all operands f32:

    dt, xs [B, L, E]; A_T [N, E]; Bs, Cs [B, L, N]; D [E]; h0 [1 or B, N, E]
    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t;  y_t = C_t . h_t + D x_t

``selective_ssm`` and ``selective_ssm_h0`` are differentiable: when grad is
enabled and an operand requires it they run as a ``torch.autograd.Function``
whose forward is K9 and whose backward is K10 (h0 is a constant of the
step: no gradient); otherwise K7/K8 as in serving.

``selective_ssm_gated`` is the mixer's serving form of K7, K8 and the
prefill: it takes the mixer's raw tensors (dt_proj's output before the
softplus, A_log, strided views of x_proj's and in_proj's outputs) at the
compute dtype and returns the gated output ``y.to(dtype) * silu(z)``, with
the glue inside the same kernel. It counts its launches in the form's own
counter. Each wrapper counts its own launches (``.launches``), so a run can
tell the variants apart.

A CPU tensor takes the plain version (the backward's is autograd through
the plain forward); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

STATE_SIZES = (4, 8, 16)  # the kernels' instances of N
# the forward's decomposition (csrc/selective_scan.cu): a channel's N states
# in N / 4 groups of 4, a thread each; exp(dt A) taken as 2^(dt (A log2 e))
FWD_STATES_PER_THREAD = 4
LOG2E = 1.4426950408889634
CHUNK = 16  # tokens per recorded chunk-start state in training (JAX's _CHUNK)
# K10's decomposition (csrc/selective_scan_bwd.cu): 4 states a thread,
# sub-chunks of up to 16 tokens whose states stay in registers, 256-thread
# blocks of 1024 / N channels, one dB/dC slab each
BWD_STATES_PER_LANE = 4
BWD_SUB_CHUNK = 16


def fwd_groups(N: int) -> int:
    """The groups one channel's states are split over in the forward."""
    return N // FWD_STATES_PER_THREAD


def bwd_block_channels(N: int) -> int:
    """The channels one block of K10 covers at state size N."""
    return 256 * BWD_STATES_PER_LANE // N


def _plain_scan(dt, A_T, Bs, Cs, xs, D, h0, chunk):
    """A loop over L on the [B, N, E] state -> (y [B, L, E], h_final
    [B, N, E], the list of states before every token c * chunk; empty for
    chunk 0)."""
    B, L, E = dt.shape
    N = A_T.shape[0]
    h = (torch.zeros(B, N, E, dtype=torch.float32, device=dt.device)
         if h0 is None else h0.float().expand(B, N, E))
    ys, hb = [], []
    for t in range(L):
        if chunk and t % chunk == 0:
            hb.append(h)
        dA = torch.exp(dt[:, t, None, :] * A_T[None])
        dBx = (dt[:, t] * xs[:, t])[:, None, :] * Bs[:, t, :, None]
        h = dA * h + dBx
        ys.append((h * Cs[:, t, :, None]).sum(dim=1))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(dt)
    return y + D * xs, h.contiguous(), hb


def selective_ssm_final_plain(dt, A_T, Bs, Cs, xs, D, h0=None):
    """(y [B, L, E], h_final [B, N, E])."""
    return _plain_scan(dt, A_T, Bs, Cs, xs, D, h0, 0)[:2]


def selective_ssm_plain(dt, A_T, Bs, Cs, xs, D, h0=None):
    return _plain_scan(dt, A_T, Bs, Cs, xs, D, h0, 0)[0]


def n_chunks(L: int, chunk: int) -> int:
    return -(-L // chunk)


def selective_ssm_split(dt, A_T, Bs, Cs, xs, D, h0=None, chunk=0):
    """The forward kernel's decomposition in PyTorch -> (y [B, L, E],
    h_final [B, N, E], hb [B, ceil(L / chunk), N, E] or None for chunk 0),
    the plain version's outputs: log2(e) folded into A once, one 2^x a (t,
    n); dt * x once a (t, e); each group's ``FWD_STATES_PER_THREAD`` states
    summed in order, then the groups pairwise ((g0 + g1) + (g2 + g3)); y +
    D x last. The CPU tests hold it against the plain version and the
    Pallas kernels."""
    B, L, E = dt.shape
    N = A_T.shape[0]
    groups = fwd_groups(N)
    a2 = A_T * LOG2E
    dbx = dt * xs
    h = (torch.zeros(B, N, E, dtype=torch.float32, device=dt.device)
         if h0 is None else h0.float().expand(B, N, E))
    ys, hb = [], []
    for t in range(L):
        if chunk and t % chunk == 0:
            hb.append(h)
        h = torch.exp2(dt[:, t, None, :] * a2) * h + dbx[:, t, None, :] * Bs[:, t, :, None]
        terms = (h * Cs[:, t, :, None]).reshape(B, groups, FWD_STATES_PER_THREAD, E)
        acc = terms[:, :, 0]
        for k in range(1, FWD_STATES_PER_THREAD):
            acc = acc + terms[:, :, k]
        while acc.shape[1] > 1:
            acc = acc[:, 0::2] + acc[:, 1::2]
        ys.append(acc[:, 0])
    y = torch.stack(ys, dim=1) + D * xs
    return y, h.contiguous(), torch.stack(hb, dim=1) if chunk else None


def scan_operands(dt_raw, A_log, Bs, Cs, xs, D):
    """The mixer's glue in front of the scan (JAX's mamba.py:131-151) ->
    (dt, A_T, Bs, Cs, xs, D), the raw interface's f32 operands:
    softplus(dt_raw) in f32, A_T = -exp(A_log) in f32, transposed."""
    # jax.nn.softplus is logaddexp(x, 0); F.softplus returns x above 20,
    # where the two differ by less than exp(-20)
    dt = F.softplus(dt_raw.float())
    A_T = (-torch.exp(A_log.float())).T.contiguous()  # [N, E]
    return (dt, A_T, Bs.float().contiguous(), Cs.float().contiguous(),
            xs.float().contiguous(), D.float())


def selective_ssm_gated_plain(dt_raw, A_log, Bs, Cs, xs, D, z, h0=None, final=False):
    """The mixer's composition around the scan -> out [B, L, E] at z's
    dtype (and h_final [B, N, E] f32 when ``final``): ``scan_operands``, the
    plain scan, then y.to(z.dtype) * silu(z) (JAX's mamba.py:157)."""
    y, h_final, _ = _plain_scan(*scan_operands(dt_raw, A_log, Bs, Cs, xs, D), h0, 0)
    out = y.to(z.dtype) * F.silu(z)
    return (out, h_final) if final else out


def selective_ssm_bounds_plain(dt, A_T, Bs, Cs, xs, D, h0=None, chunk=CHUNK):
    """(y [B, L, E], hb [B, ceil(L / chunk), N, E]), hb[:, c] the state
    before token c * chunk (hb[:, 0] = h0 or 0)."""
    y, _, hb = _plain_scan(dt, A_T, Bs, Cs, xs, D, h0, chunk)
    return y, torch.stack(hb, dim=1).contiguous()


def selective_ssm_bwd_plain(dt, A_T, Bs, Cs, xs, g, hb, chunk=CHUNK):
    """(ddt, dx_ssm, dB, dC, dA_T), in THAT order (JAX's _ssm_pallas_bwd):
    autograd through the plain forward seeded with hb[:, 0], with D = 0, so
    dx_ssm leaves out the D * g term the caller adds. ``chunk`` is the one
    hb was recorded with."""
    if hb.shape[1] != n_chunks(dt.shape[1], chunk):
        raise ValueError(f"hb {tuple(hb.shape)} does not hold ceil(L / {chunk}) chunks")
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (dt, A_T, Bs, Cs, xs)]
        y = selective_ssm_plain(*ins, torch.zeros_like(dt[0, 0]), hb[:, 0])
        ddt, dA_T, dB, dC, dx = torch.autograd.grad(y, ins, g)
    return ddt, dx, dB, dC, dA_T


def selective_ssm_bwd_split(dt, A_T, Bs, Cs, xs, g, hb, chunk=CHUNK):
    """K10's decomposition in PyTorch -> (ddt, dx_ssm, dB, dC, dA_T), the
    plain version's outputs: the recorded chunks right to left, each in
    sub-chunks of up to ``BWD_SUB_CHUNK`` tokens that run forward once from
    the chunk's recorded start, keeping h_{t-1} and exp(dt A) (one
    exponential per (t, n)), then backward from them; ddt and dx summed
    within each group of ``BWD_STATES_PER_LANE`` states, then over the
    groups; dB and dC summed per block of ``bwd_block_channels(N)`` channels
    (the kernel's slabs), then over the blocks; dA_T per batch row, then over
    them. The CPU tests hold it against the plain version and the Pallas
    kernel."""
    B, L, E = dt.shape
    N = A_T.shape[0]
    nc, cpb = n_chunks(L, chunk), bwd_block_channels(N)
    n_slabs, groups = -(-E // cpb), N // BWD_STATES_PER_LANE

    def per_group(t):  # [B, N, E] -> [B, E]
        return t.reshape(B, groups, BWD_STATES_PER_LANE, E).sum(2).sum(1)

    def per_block(t):  # [B, N, E] -> [n_slabs, B, N]
        t = torch.nn.functional.pad(t, (0, n_slabs * cpb - E))
        return t.reshape(B, N, n_slabs, cpb).sum(-1).permute(2, 0, 1)

    ddt, dx = torch.empty_like(dt), torch.empty_like(dt)
    slab_b, slab_c = (dt.new_zeros(n_slabs, B, L, N) for _ in range(2))
    dA_T, hhat = dt.new_zeros(B, N, E), dt.new_zeros(B, N, E)
    for c in reversed(range(nc)):
        cs, s_end = c * chunk, min(L, (c + 1) * chunk)
        while s_end > cs:
            s0 = cs + (s_end - 1 - cs) // BWD_SUB_CHUNK * BWD_SUB_CHUNK
            h, hist, das = hb[:, c], [], []
            for t in range(cs, s_end):
                dA = torch.exp(dt[:, t, None, :] * A_T)
                if t >= s0:
                    hist.append(h)
                    das.append(dA)
                h = dA * h + (dt[:, t] * xs[:, t])[:, None, :] * Bs[:, t, :, None]
            for i in reversed(range(s_end - s0)):
                t = s0 + i
                hp, dA = hist[i], das[i]
                dbx = (dt[:, t] * xs[:, t])[:, None, :]
                b_, g_ = Bs[:, t, :, None], g[:, t, None, :]
                hh = Cs[:, t, :, None] * g_ + hhat
                hp_dA = hh * hp * dA
                s_hb = per_group(hh * b_)
                ddt[:, t] = per_group(hp_dA * A_T) + s_hb * xs[:, t]
                dx[:, t] = s_hb * dt[:, t]
                slab_b[:, :, t] = per_block(hh * dbx)
                slab_c[:, :, t] = per_block((dA * hp + dbx * b_) * g_)
                dA_T += hp_dA * dt[:, t, None, :]
                hhat = dA * hh
            s_end = s0
    return ddt, dx, slab_b.sum(0), slab_c.sum(0), dA_T.sum(0)


def _check(dt, A_T, Bs, Cs, xs, D=None, h0=None):
    """Check the scan's operands (D and h0 when given) for the kernels."""
    B, L, E = dt.shape
    N = A_T.shape[0]
    if N not in STATE_SIZES:
        raise ValueError(f"state size {N} not supported {STATE_SIZES}")
    if (xs.shape != dt.shape or A_T.shape != (N, E) or Bs.shape != (B, L, N)
            or Cs.shape != Bs.shape or (D is not None and D.shape != (E,))):
        raise ValueError(f"dt {tuple(dt.shape)} A_T {tuple(A_T.shape)} Bs "
                         f"{tuple(Bs.shape)} Cs {tuple(Cs.shape)} xs "
                         f"{tuple(xs.shape)} D {None if D is None else tuple(D.shape)}")
    tensors = [dt, A_T, Bs, Cs, xs] + ([] if D is None else [D])
    if h0 is not None:
        if h0.dim() != 3 or h0.shape[0] not in (1, B) or h0.shape[1:] != (N, E):
            raise ValueError(f"h0 must be [1 or {B}, {N}, {E}], got {tuple(h0.shape)}")
        tensors.append(h0)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"the scan takes f32 operands, got {[t.dtype for t in tensors]}")
    _build.check_cuda(*tensors)


def _launch(dt, xs, z, Bs, Cs, A, D, h0, out, h_final, hb, chunk, lds, is_bf16,
            params_bf16):
    """One call of ``mt_selective_scan`` (z None: the raw interface)."""
    B, L, E = dt.shape
    N = Bs.shape[2]
    ptr = _build.ptr
    _build.launch("mt_selective_scan", dt.device, ptr(dt), ptr(xs), ptr(z), ptr(Bs), ptr(Cs),
                  ptr(A), ptr(D), ptr(h0), int(h0 is not None and h0.shape[0] > 1), ptr(out),
                  ptr(h_final), ptr(hb), chunk, B, L, E, N, *lds, int(is_bf16),
                  int(params_bf16))


def _scan(dt, A_T, Bs, Cs, xs, D, h0, final: bool, chunk: int = 0):
    """Check the operands and launch the forward kernel; returns (y, h_final
    or None, hb or None). ``chunk`` > 0 records the chunk-start states."""
    _check(dt, A_T, Bs, Cs, xs, D, h0)
    B, L, E = dt.shape
    N = A_T.shape[0]
    y = torch.empty_like(dt)
    h_final = torch.empty(B, N, E, dtype=torch.float32, device=dt.device) if final else None
    hb = (torch.empty(B, n_chunks(L, chunk), N, E, dtype=torch.float32, device=dt.device)
          if chunk else None)
    _launch(dt, xs, None, Bs, Cs, A_T, D, h0, y, h_final, hb, chunk, (E, E, 0, N), False,
            False)
    return y, h_final, hb


def _row_stride(t, name: str) -> int:
    """The elements between the rows of a [B, L, W] view whose rows are
    contiguous and evenly spaced (a column slice of a contiguous [B, L, W']
    buffer); raises for any other layout."""
    B, L, W = t.shape
    ld = t.stride(1) if L > 1 else t.stride(0) if B > 1 else W
    if t.stride(2) != 1 or ld < W or (B > 1 and t.stride(0) != L * ld):
        raise ValueError(f"{name} {tuple(t.shape)} strides {t.stride()}: the kernel reads "
                         "rows of contiguous elements, evenly spaced")
    return ld


def _check_gated(dt_raw, A_log, Bs, Cs, xs, D, z, h0):
    """Check the gated form's operands; returns the row strides (dt_raw, xs,
    z, Bs and Cs)."""
    B, L, E = dt_raw.shape
    N = Bs.shape[-1]
    if N not in STATE_SIZES:
        raise ValueError(f"state size {N} not supported {STATE_SIZES}")
    if (xs.shape != dt_raw.shape or z.shape != dt_raw.shape or Bs.shape != (B, L, N)
            or Cs.shape != Bs.shape or A_log.shape != (E, N) or D.shape != (E,)):
        raise ValueError(f"dt_raw {tuple(dt_raw.shape)} A_log {tuple(A_log.shape)} Bs "
                         f"{tuple(Bs.shape)} Cs {tuple(Cs.shape)} xs {tuple(xs.shape)} D "
                         f"{tuple(D.shape)} z {tuple(z.shape)}")
    if L < 1:
        raise ValueError("the scan needs at least one token")
    kinds = (torch.float32, torch.bfloat16)
    if (z.dtype not in kinds or any(t.dtype != z.dtype for t in (dt_raw, xs, Bs, Cs))
            or A_log.dtype not in kinds or D.dtype != A_log.dtype):
        raise ValueError("the gated scan takes dt_raw, Bs, Cs, xs, z at one dtype and A_log, "
                         "D at one dtype, each f32 or bf16; got "
                         f"{[t.dtype for t in (dt_raw, A_log, Bs, Cs, xs, D, z)]}")
    tensors = [dt_raw, A_log, Bs, Cs, xs, D, z]
    if h0 is not None:
        if h0.dim() != 3 or h0.shape[0] not in (1, B) or h0.shape[1:] != (N, E):
            raise ValueError(f"h0 must be [1 or {B}, {N}, {E}], got {tuple(h0.shape)}")
        if h0.dtype != torch.float32 or not h0.is_contiguous():
            raise ValueError(f"h0 must be contiguous f32, got {h0.dtype}")
        tensors.append(h0)
    dev = dt_raw.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("the kernel runs on CUDA tensors on one device")
    if not (A_log.is_contiguous() and D.is_contiguous()):
        raise ValueError("A_log and D must be contiguous")
    ld_bc = _row_stride(Bs, "Bs")
    if _row_stride(Cs, "Cs") != ld_bc:
        raise ValueError("Bs and Cs must share their row stride (views of one x_proj output)")
    return (_row_stride(dt_raw, "dt_raw"), _row_stride(xs, "xs"), _row_stride(z, "z"), ld_bc)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def selective_ssm(dt, A_T, Bs, Cs, xs, D):
    """The scan from h = 0 -> y [B, L, E]. Differentiable (K9 forward, K10
    backward) when an operand requires grad; else K7, counted in
    ``selective_ssm.launches``."""
    if _wants_grad(dt, A_T, Bs, Cs, xs, D):
        return _SelectiveScan.apply(dt, A_T, Bs, Cs, xs, D, None)
    if dt.device.type == "cpu":
        return selective_ssm_plain(dt, A_T, Bs, Cs, xs, D)
    y, _, _ = _scan(dt, A_T, Bs, Cs, xs, D, None, final=False)
    selective_ssm.launches += 1
    return y


def selective_ssm_h0(dt, A_T, Bs, Cs, xs, D, h0):
    """The scan resumed from h0 [1 or B, N, E] -> y [B, L, E].
    Differentiable in all but h0 (K9 forward, K10 backward) when an operand
    requires grad; else K8, counted in ``selective_ssm_h0.launches``."""
    if _wants_grad(dt, A_T, Bs, Cs, xs, D):
        return _SelectiveScan.apply(dt, A_T, Bs, Cs, xs, D, h0)
    if dt.device.type == "cpu":
        return selective_ssm_plain(dt, A_T, Bs, Cs, xs, D, h0)
    y, _, _ = _scan(dt, A_T, Bs, Cs, xs, D, h0, final=False)
    selective_ssm_h0.launches += 1
    return y


def selective_ssm_final(dt, A_T, Bs, Cs, xs, D, h0=None):
    """The prefill form -> (y [B, L, E], h_final [B, N, E]). Counts CUDA
    launches in ``selective_ssm_final.launches``."""
    if dt.device.type == "cpu":
        return selective_ssm_final_plain(dt, A_T, Bs, Cs, xs, D, h0)
    y, h_final, _ = _scan(dt, A_T, Bs, Cs, xs, D, h0, final=True)
    selective_ssm_final.launches += 1
    return y, h_final


def selective_ssm_bounds(dt, A_T, Bs, Cs, xs, D, h0=None, chunk=CHUNK):
    """K9: the scan from h0 (or 0) -> (y [B, L, E], hb [B, ceil(L / chunk),
    N, E]), hb[:, c] the state before token c * chunk. Counts CUDA launches
    in ``selective_ssm_bounds.launches``."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if dt.device.type == "cpu":
        return selective_ssm_bounds_plain(dt, A_T, Bs, Cs, xs, D, h0, chunk)
    y, _, hb = _scan(dt, A_T, Bs, Cs, xs, D, h0, final=False, chunk=chunk)
    selective_ssm_bounds.launches += 1
    return y, hb


def selective_ssm_bwd(dt, A_T, Bs, Cs, xs, g, hb, chunk=CHUNK, need_dA=True):
    """K10: the reverse adjoint from the states K9 recorded -> (ddt, dx_ssm,
    dB, dC, dA_T) in THAT order (as ``_ssm_pallas_bwd``: with N == E the
    [B, L, E] and [B, L, N] gradients shape-match, so a swapped unpack would
    be silent); dx_ssm leaves out D * g, the caller adds it and dD. dA_T is
    None when ``need_dA`` is false (A frozen), and the kernel then skips it.
    Counts CUDA launches in ``selective_ssm_bwd.launches``."""
    if dt.device.type == "cpu":
        ddt, dx, dB, dC, dA_T = selective_ssm_bwd_plain(dt, A_T, Bs, Cs, xs, g, hb, chunk)
        return ddt, dx, dB, dC, dA_T if need_dA else None
    _check(dt, A_T, Bs, Cs, xs)
    B, L, E = dt.shape
    N = A_T.shape[0]
    if g.shape != dt.shape or hb.shape != (B, n_chunks(L, chunk), N, E) or chunk < 1:
        raise ValueError(f"g {tuple(g.shape)} hb {tuple(hb.shape)} chunk {chunk} for "
                         f"dt {tuple(dt.shape)}, N {N}")
    if g.dtype != torch.float32 or hb.dtype != torch.float32:
        raise ValueError(f"g and hb must be f32, got {g.dtype} {hb.dtype}")
    _build.check_cuda(dt, g, hb)
    ddt, dx = torch.empty_like(dt), torch.empty_like(dt)
    n_slabs = _build.library().mt_selective_scan_bwd_slabs(E, N)  # one per block
    slabs = torch.empty(2, n_slabs, B, L, N, dtype=torch.float32, device=dt.device)
    dA_slab = (torch.empty(B, N, E, dtype=torch.float32, device=dt.device)
               if need_dA else None)
    ptr = _build.ptr
    _build.launch("mt_selective_scan_bwd", dt.device, ptr(dt), ptr(xs), ptr(Bs), ptr(Cs),
                  ptr(A_T), ptr(g), ptr(hb), ptr(ddt), ptr(dx), ptr(slabs[0]),
                  ptr(slabs[1]), ptr(dA_slab), n_slabs, chunk, B, L, E, N)
    selective_ssm_bwd.launches += 1
    dB, dC = slabs.sum(dim=1)
    return ddt, dx, dB, dC, None if dA_slab is None else dA_slab.sum(dim=0)


class _SelectiveScan(torch.autograd.Function):
    """The custom_vjp of ``selective_ssm`` / ``selective_ssm_h0``: K9
    records the chunk-start states, K10 runs the adjoint from them. h0 (the
    cached prompt-head state, a constant of the step) gets no gradient."""

    @staticmethod
    def forward(ctx, dt, A_T, Bs, Cs, xs, D, h0):
        y, hb = selective_ssm_bounds(dt, A_T, Bs, Cs, xs, D, h0, CHUNK)
        ctx.save_for_backward(dt, A_T, Bs, Cs, xs, D, hb)
        return y

    @staticmethod
    def backward(ctx, g):
        dt, A_T, Bs, Cs, xs, D, hb = ctx.saved_tensors
        need = ctx.needs_input_grad
        g = g.float().contiguous()
        ddt, dx, dB, dC, dA_T = selective_ssm_bwd(dt, A_T, Bs, Cs, xs, g, hb, CHUNK,
                                                  need_dA=need[1])
        dD = (g * xs).sum(dim=(0, 1)) if need[5] else None
        return ddt, dA_T, dB, dC, dx + D * g, dD, None


def selective_ssm_gated(dt_raw, A_log, Bs, Cs, xs, D, z, h0=None, final=False):
    """The mixer's serving form of the scan -> out [B, L, E] at z's dtype,
    and h_final [B, N, E] f32 when ``final`` (the prefill): the kernel
    softplus'es dt_raw (dt_proj's output [B, L, E]) in f32, takes A = -exp(
    A_log [E, N]), scans from h0 [1 or B, N, E] (or 0), adds D x and writes
    round(round(y) * round(silu(z))) at the compute dtype, the plain
    version's ``y.to(dtype) * F.silu(z)``. dt_raw, Bs, Cs, xs and z are at
    the compute dtype (f32 or bf16) and may be column slices of wider
    buffers (x_proj's, in_proj's outputs); A_log and D at theirs. Serving
    only: raises when an operand wants a gradient (training runs
    ``selective_ssm`` / ``selective_ssm_h0``). Counts CUDA launches in the
    form's counter: ``selective_ssm_final`` with ``final``, else
    ``selective_ssm_h0`` with h0, else ``selective_ssm``."""
    if _wants_grad(dt_raw, A_log, Bs, Cs, xs, D, z):
        raise ValueError("selective_ssm_gated is the serving form and has no backward; a "
                         "step that needs gradients runs selective_ssm / selective_ssm_h0")
    if dt_raw.device.type == "cpu":
        return selective_ssm_gated_plain(dt_raw, A_log, Bs, Cs, xs, D, z, h0, final)
    lds = _check_gated(dt_raw, A_log, Bs, Cs, xs, D, z, h0)
    B, L, E = dt_raw.shape
    N = Bs.shape[-1]
    out = torch.empty(B, L, E, dtype=z.dtype, device=z.device)
    h_final = (torch.empty(B, N, E, dtype=torch.float32, device=z.device) if final
               else None)
    _launch(dt_raw, xs, z, Bs, Cs, A_log, D, h0, out, h_final, None, 0, lds,
            z.dtype == torch.bfloat16, A_log.dtype == torch.bfloat16)
    counter = (selective_ssm_final if final else selective_ssm_h0 if h0 is not None
               else selective_ssm)
    counter.launches += 1
    return (out, h_final) if final else out


selective_ssm.launches = 0
selective_ssm_h0.launches = 0
selective_ssm_final.launches = 0
selective_ssm_bounds.launches = 0
selective_ssm_bwd.launches = 0
