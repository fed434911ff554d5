"""Multiwavelet ops (port of ``medtsllm_tpu/ops/wavelets.py``:
``get_phi_psi``, ``get_filter``, ``filter_bank``, ``SparseKernelFT1d``,
``MWT_CZ1d``, ``MultiWaveletTransform``, ``FourierCrossAttentionW`` and
``MultiWaveletCross``): FEDformer's ``version = "Wavelets"``.

The Legendre / Chebyshev filter banks are synthesized on the host at
construction, as in JAX, following the published FEDformer recipe. JAX
(and the reference) take the polynomials' coefficients and the Legendre
roots from sympy, which the card's machine lacks. The port computes the
coefficients of P_n(2x - 1), P_n(4x - 1), T_n(2x - 1) and T_n(4x - 1)
exactly, by the three-term recurrences in rational arithmetic
(``fractions``), so each float64 coefficient is the correctly rounded
value sympy's exact one converts to; it takes the roots of P_k(2x - 1)
from ``numpy.polynomial.legendre.leggauss`` and polishes each by Newton
steps in rational arithmetic before rounding (sympy's ``all_roots`` to 20
digits, then float64, in JAX). The rest of the synthesis is the JAX
package's numpy and scipy code.

The runtime cascade (decompose, attend, reconstruct) has static trip
counts: ns = floor(log2 N) levels with N fixed by the model.
"""

from __future__ import annotations

import math
from fractions import Fraction
from functools import lru_cache, partial

import numpy as np
import torch
from torch import nn

from ..models.llm.transformer import Linear
from .dft import complex_einsum_ri, irfft_ri, rfft_ri
from .fourier import frequency_activation

# ---------------------------------------------------------------------------
# host-side filter synthesis
# ---------------------------------------------------------------------------


def _poly_mul(a: list, b: list) -> list:
    out = [Fraction(0)] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] += x * y
    return out


def _poly_add(a: list, b: list) -> list:
    n = max(len(a), len(b))
    return [(a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0) for i in range(n)]


def shifted_poly(kind: str, n: int, a: int, b: int) -> list[Fraction]:
    """The exact coefficients, lowest degree first, of P_n(a x + b)
    (``kind`` "legendre") or T_n(a x + b) ("chebyshev"), by the
    three-term recurrences in rational arithmetic."""
    y = [Fraction(b), Fraction(a)]
    prev, cur = [Fraction(1)], y
    if n == 0:
        return prev
    for m in range(1, n):
        if kind == "legendre":  # (m + 1) P_{m+1} = (2m + 1) y P_m - m P_{m-1}
            nxt = _poly_add([c * (2 * m + 1) for c in _poly_mul(y, cur)],
                            [-c * m for c in prev])
            nxt = [c / (m + 1) for c in nxt]
        else:  # T_{m+1} = 2 y T_m - T_{m-1}
            nxt = _poly_add([2 * c for c in _poly_mul(y, cur)], [-c for c in prev])
        prev, cur = cur, nxt
    return cur


def _coeffs(kind: str, n: int, a: int, b: int) -> np.ndarray:
    return np.array([float(c) for c in shifted_poly(kind, n, a, b)], dtype=np.float64)


def _legendre_roots(k: int) -> np.ndarray:
    """The k roots of P_k(2x - 1), ascending: Gauss-Legendre nodes mapped to
    [0, 1], each polished by Newton steps on the exact polynomial."""
    p = shifted_poly("legendre", k, 2, -1)
    dp = [c * i for i, c in enumerate(p)][1:]

    def ev(poly, x):
        out = Fraction(0)
        for c in reversed(poly):
            out = out * x + c
        return out
    roots = []
    for r in (np.polynomial.legendre.leggauss(k)[0] + 1.0) / 2.0:
        x = Fraction(float(r))
        for _ in range(3):
            x -= ev(p, x) / ev(dp, x)
            x = x.limit_denominator(1 << 120)
        roots.append(float(x))
    return np.array(roots, dtype=np.float64)


def _legendre_der(k, x):
    from scipy.special import eval_legendre

    out = 0
    for i in np.arange(k - 1, -1, -2):
        out += (2 * i + 1) * eval_legendre(i, x)
    return out


def _phi_eval(phi_c, x, lb=0.0, ub=1.0):
    mask = np.logical_or(x < lb, x > ub) * 1.0
    return np.polynomial.polynomial.Polynomial(phi_c)(x) * (1 - mask)


def _proj_sum(prod_, weights) -> float:
    prod_[np.abs(prod_) < 1e-8] = 0
    return (prod_ / (np.arange(len(prod_)) + 1) * weights(np.arange(len(prod_)))).sum()


@lru_cache(maxsize=8)
def get_phi_psi(k: int, base: str):
    """The scaling functions phi and the wavelets psi1 (on [0, 1/2]) and
    psi2 (on [1/2, 1]) of order k: (phi, psi1, psi2), each k callables."""
    phi_coeff = np.zeros((k, k))
    phi_2x_coeff = np.zeros((k, k))
    if base == "legendre":
        for ki in range(k):
            phi_coeff[ki, :ki + 1] = np.sqrt(2 * ki + 1) * _coeffs("legendre", ki, 2, -1)
            phi_2x_coeff[ki, :ki + 1] = (np.sqrt(2) * np.sqrt(2 * ki + 1)
                                         * _coeffs("legendre", ki, 4, -1))
        psi1_coeff = np.zeros((k, k))
        psi2_coeff = np.zeros((k, k))

        def low(i):
            return np.power(0.5, 1 + i)

        def high(i):
            return 1 - np.power(0.5, 1 + i)

        def proj(a, b):
            return _proj_sum(np.convolve(a, b), low)

        for ki in range(k):
            psi1_coeff[ki, :] = phi_2x_coeff[ki, :]
            for i in range(k):
                p = proj(phi_2x_coeff[ki, :ki + 1], phi_coeff[i, :i + 1])
                psi1_coeff[ki, :] -= p * phi_coeff[i, :]
                psi2_coeff[ki, :] -= p * phi_coeff[i, :]
            for j in range(ki):
                p = proj(phi_2x_coeff[ki, :ki + 1], psi1_coeff[j, :])
                psi1_coeff[ki, :] -= p * psi1_coeff[j, :]
                psi2_coeff[ki, :] -= p * psi2_coeff[j, :]
            a = psi1_coeff[ki, :]
            norm1 = _proj_sum(np.convolve(a, a), low)
            a = psi2_coeff[ki, :]
            norm2 = _proj_sum(np.convolve(a, a), high)
            norm_ = np.sqrt(norm1 + norm2)
            psi1_coeff[ki, :] /= norm_
            psi2_coeff[ki, :] /= norm_
            psi1_coeff[np.abs(psi1_coeff) < 1e-8] = 0
            psi2_coeff[np.abs(psi2_coeff) < 1e-8] = 0

        phi = [np.poly1d(np.flip(phi_coeff[i, :])) for i in range(k)]
        psi1 = [np.poly1d(np.flip(psi1_coeff[i, :])) for i in range(k)]
        psi2 = [np.poly1d(np.flip(psi2_coeff[i, :])) for i in range(k)]
        return phi, psi1, psi2

    if base == "chebyshev":
        for ki in range(k):
            if ki == 0:
                phi_coeff[ki, :ki + 1] = np.sqrt(2 / np.pi)
                phi_2x_coeff[ki, :ki + 1] = np.sqrt(2 / np.pi) * np.sqrt(2)
            else:
                phi_coeff[ki, :ki + 1] = 2 / np.sqrt(np.pi) * _coeffs("chebyshev", ki, 2, -1)
                phi_2x_coeff[ki, :ki + 1] = (np.sqrt(2) * 2 / np.sqrt(np.pi)
                                             * _coeffs("chebyshev", ki, 4, -1))
        phi = [partial(_phi_eval, phi_coeff[i, :]) for i in range(k)]
        kUse = 2 * k
        # the roots of T_kUse(2x - 1) are analytic
        x_m = (np.cos((2 * np.arange(kUse) + 1) * np.pi / (2 * kUse)) + 1) / 2
        wm = np.pi / kUse / 2
        psi1_coeff = np.zeros((k, k))
        psi2_coeff = np.zeros((k, k))
        psi1 = [None] * k
        psi2 = [None] * k
        for ki in range(k):
            psi1_coeff[ki, :] = phi_2x_coeff[ki, :]
            for i in range(k):
                p = (wm * phi[i](x_m) * np.sqrt(2)
                     * _phi_eval(phi_2x_coeff[ki, :], x_m)).sum()
                psi1_coeff[ki, :] -= p * phi_coeff[i, :]
                psi2_coeff[ki, :] -= p * phi_coeff[i, :]
            for j in range(ki):
                p = (wm * psi1[j](x_m) * np.sqrt(2)
                     * _phi_eval(phi_2x_coeff[ki, :], x_m)).sum()
                psi1_coeff[ki, :] -= p * psi1_coeff[j, :]
                psi2_coeff[ki, :] -= p * psi2_coeff[j, :]
            psi1[ki] = partial(_phi_eval, psi1_coeff[ki, :], lb=0, ub=0.5)
            psi2[ki] = partial(_phi_eval, psi2_coeff[ki, :], lb=0.5, ub=1)
            norm1 = (wm * psi1[ki](x_m) * psi1[ki](x_m)).sum()
            norm2 = (wm * psi2[ki](x_m) * psi2[ki](x_m)).sum()
            norm_ = np.sqrt(norm1 + norm2)
            psi1_coeff[ki, :] /= norm_
            psi2_coeff[ki, :] /= norm_
            psi1_coeff[np.abs(psi1_coeff) < 1e-8] = 0
            psi2_coeff[np.abs(psi2_coeff) < 1e-8] = 0
            psi1[ki] = partial(_phi_eval, psi1_coeff[ki, :], lb=0, ub=0.5 + 1e-16)
            psi2[ki] = partial(_phi_eval, psi2_coeff[ki, :], lb=0.5 + 1e-16, ub=1)
        return phi, psi1, psi2
    raise ValueError(f"Base {base} not supported")


@lru_cache(maxsize=8)
def get_filter(base: str, k: int):
    """The decomposition / reconstruction filters (H0, H1, G0, G1, PHI0,
    PHI1), each [k, k] float64."""
    from scipy.special import eval_legendre

    if base not in ("legendre", "chebyshev"):
        raise ValueError("Base not supported")

    def psi(psi1, psi2, i, inp):
        mask = (inp <= 0.5) * 1.0
        return psi1[i](inp) * mask + psi2[i](inp) * (1 - mask)

    H0, H1, G0, G1 = (np.zeros((k, k)) for _ in range(4))
    phi, psi1, psi2 = get_phi_psi(k, base)
    if base == "legendre":
        x_m = _legendre_roots(k)
        wm = (1 / k / _legendre_der(k, 2 * x_m - 1)
              / eval_legendre(k - 1, 2 * x_m - 1))
    else:
        kUse = 2 * k
        x_m = (np.cos((2 * np.arange(kUse) + 1) * np.pi / (2 * kUse)) + 1) / 2
        wm = np.pi / kUse / 2
    for ki in range(k):
        for kpi in range(k):
            H0[ki, kpi] = (wm * phi[ki](x_m / 2) * phi[kpi](x_m)).sum() / np.sqrt(2)
            G0[ki, kpi] = (wm * psi(psi1, psi2, ki, x_m / 2)
                           * phi[kpi](x_m)).sum() / np.sqrt(2)
            H1[ki, kpi] = (wm * phi[ki]((x_m + 1) / 2) * phi[kpi](x_m)).sum() / np.sqrt(2)
            G1[ki, kpi] = (wm * psi(psi1, psi2, ki, (x_m + 1) / 2)
                           * phi[kpi](x_m)).sum() / np.sqrt(2)
    if base == "legendre":
        PHI0 = np.eye(k)
        PHI1 = np.eye(k)
    else:
        PHI0, PHI1 = np.zeros((k, k)), np.zeros((k, k))
        for ki in range(k):
            for kpi in range(k):
                PHI0[ki, kpi] = (wm * phi[ki](2 * x_m) * phi[kpi](2 * x_m)).sum() * 2
                PHI1[ki, kpi] = (wm * phi[ki](2 * x_m - 1)
                                 * phi[kpi](2 * x_m - 1)).sum() * 2
        PHI0[np.abs(PHI0) < 1e-8] = 0
        PHI1[np.abs(PHI1) < 1e-8] = 0
    for M in (H0, H1, G0, G1):
        M[np.abs(M) < 1e-8] = 0
    return H0, H1, G0, G1, PHI0, PHI1


def filter_bank(base: str, k: int):
    """(ec_s, ec_d, rc_e, rc_o) as float32 arrays: the decomposition
    filters [2k, k] and the even / odd reconstruction filters [2k, k]."""
    H0, H1, G0, G1, PHI0, PHI1 = get_filter(base, k)
    H0r, G0r, H1r, G1r = H0 @ PHI0, G0 @ PHI0, H1 @ PHI1, G1 @ PHI1
    for M in (H0r, H1r, G0r, G1r):
        M[np.abs(M) < 1e-8] = 0
    return (np.concatenate((H0.T, H1.T), axis=0).astype(np.float32),
            np.concatenate((G0.T, G1.T), axis=0).astype(np.float32),
            np.concatenate((H0r, G0r), axis=0).astype(np.float32),
            np.concatenate((H1r, G1r), axis=0).astype(np.float32))


class _FilterBank(nn.Module):
    """A module holding ``filter_bank(base, k)`` as non-persistent buffers
    (``ec_s``, ``ec_d``, ``rc_e``, ``rc_o``)."""

    def __init__(self, base: str, k: int):
        super().__init__()
        for name, arr in zip(("ec_s", "ec_d", "rc_e", "rc_o"), filter_bank(base, k)):
            self.register_buffer(name, torch.tensor(arr), persistent=False)


# ---------------------------------------------------------------------------
# the runtime cascade
# ---------------------------------------------------------------------------

def wavelet_transform(x, ec_d, ec_s):
    """x [B, N, c, k] -> (d, s), each [B, N / 2, c, k]."""
    xa = torch.cat([x[:, ::2], x[:, 1::2]], dim=-1)
    return xa @ ec_d, xa @ ec_s


def even_odd(x, rc_e, rc_o, k: int):
    """The inverse step: [B, N, c, 2k] -> [B, 2N, c, k], even and odd
    positions interleaved."""
    B, N, c, _ = x.shape
    return torch.stack([x @ rc_e, x @ rc_o], dim=2).reshape(B, 2 * N, c, k)


def pad_pow2(x):
    """Wrap-pad the length axis to the next power of two."""
    N = x.shape[1]
    nl = 2 ** math.ceil(math.log2(N)) if N > 1 else 1
    return torch.cat([x, x[:, :nl - N]], dim=1) if nl > N else x


class SparseKernelFT1d(nn.Module):
    """A complex weight per low mode (the first ``alpha``) on the flattened
    c * k channels: x [B, N, c, k] -> [B, N, c, k].

    ``weights1`` / ``weights2`` keep the flax layout [c k, c k, alpha];
    ``mode_major`` copies them mode-major once a cascade, so every level
    reads its first l modes as one contiguous [l, c k, c k] block, and the
    real and imaginary parts of the input share each weight's read (two
    batched GEMMs, not the four einsums of JAX, each output element the
    same dot product)."""

    def __init__(self, k: int, alpha: int, c: int = 1):
        super().__init__()
        ck = c * k
        self.weights1 = nn.Parameter(torch.empty(ck, ck, alpha))
        self.weights2 = nn.Parameter(torch.empty(ck, ck, alpha))

    def mode_major(self):
        """(weights1, weights2) as [alpha, c k, c k] f32 copies."""
        return tuple(w.float().permute(2, 0, 1).contiguous()
                     for w in (self.weights1, self.weights2))

    def forward(self, x, weights=None):
        B, N, c, k = x.shape
        w1, w2 = self.mode_major() if weights is None else weights
        l = min(w1.shape[0], N // 2 + 1)
        xre, xim = rfft_ri(x.reshape(B, N, c * k).transpose(1, 2))
        xri = torch.cat([xre[:, :, :l], xim[:, :, :l]]).permute(2, 0, 1)  # [l, 2B, ck]
        a, b = torch.bmm(xri, w1[:l]), torch.bmm(xri, w2[:l])
        ore = (a[:, :B] - b[:, B:]).permute(1, 2, 0)  # [B, ck, l]
        oim = (b[:, :B] + a[:, B:]).permute(1, 2, 0)
        out = irfft_ri(ore, oim, n=N)  # the bins past l are zero
        return out.transpose(1, 2).reshape(B, N, c, k).to(x.dtype)


class MWT_CZ1d(nn.Module):
    """One multiwavelet cascade: ns - L levels of decomposition, each level's
    details through A and B and its smooth part through C, T0 at the
    coarsest level, then the reconstruction."""

    def __init__(self, k: int = 3, alpha: int = 64, L: int = 0, c: int = 1,
                 base: str = "legendre"):
        super().__init__()
        self.k, self.L = k, L
        self.filters = _FilterBank(base, k)
        self.A = SparseKernelFT1d(k, alpha, c)
        self.B = SparseKernelFT1d(k, alpha, c)
        self.C = SparseKernelFT1d(k, alpha, c)
        self.T0 = Linear(k, k)

    def forward(self, x):  # [B, N, c, k]
        f = self.filters
        N = x.shape[1]
        ns = math.floor(math.log2(N))
        x = pad_pow2(x)
        wA, wB, wC = self.A.mode_major(), self.B.mode_major(), self.C.mode_major()
        Ud, Us = [], []
        for _ in range(ns - self.L):
            d, x = wavelet_transform(x, f.ec_d, f.ec_s)
            Ud.append(self.A(d, wA) + self.B(x, wB))
            Us.append(self.C(d, wC))
        x = self.T0(x)
        for i in range(ns - 1 - self.L, -1, -1):
            x = torch.cat([x + Us[i], Ud[i]], dim=-1)
            x = even_odd(x, f.rc_e, f.rc_o, self.k)
        return x[:, :N]


class MultiWaveletTransform(nn.Module):
    """In place of self-attention: the values (cut or zero-padded to the
    queries' length) -> ``Lk0`` -> ``nCZ`` cascades (relu between) ->
    ``Lk1``; [B, L, H, E] -> ([B, L, H, E], None)."""

    def __init__(self, ich: int = 1, k: int = 8, alpha: int = 16, c: int = 128,
                 nCZ: int = 1, L: int = 0, base: str = "legendre"):
        super().__init__()
        self.c, self.k, self.nCZ = c, k, nCZ
        self.Lk0 = Linear(ich, c * k)
        self.Lk1 = Linear(c * k, ich)
        for i in range(nCZ):
            setattr(self, f"MWT_CZ_{i}", MWT_CZ1d(k, alpha, L, c, base))

    def forward(self, queries, keys, values, attn_mask=None, generator=None):
        B, L, H, E = queries.shape
        S = values.shape[1]
        if L > S:
            pad = torch.zeros(B, L - S, H, E, dtype=values.dtype, device=values.device)
            values = torch.cat([values, pad], dim=1)
        else:
            values = values[:, :L]
        V = self.Lk0(values.reshape(B, L, -1)).reshape(B, L, self.c, -1)
        for i in range(self.nCZ):
            V = getattr(self, f"MWT_CZ_{i}")(V)
            if i < self.nCZ - 1:
                V = torch.relu(V)
        V = self.Lk1(V.reshape(B, L, -1))
        return V.reshape(B, L, -1, E), None


class FourierCrossAttentionW(nn.Module):
    """Low-mode Fourier cross attention on wavelet coefficients
    [B, N, c, k] (no parameters)."""

    def __init__(self, in_channels: int, out_channels: int, modes: int = 16,
                 activation: str = "tanh"):
        super().__init__()
        self.denom = in_channels * out_channels
        self.modes, self.activation = modes, activation

    def forward(self, q, k, v, attn_mask=None, generator=None):
        B, L, E, H = q.shape
        mq = min(L // 2, self.modes)
        mkv = min(v.shape[1] // 2, self.modes)
        qre, qim = (t[..., :mq] for t in rfft_ri(q.permute(0, 3, 2, 1)))
        kre, kim = (t[..., :mkv] for t in rfft_ri(k.permute(0, 3, 2, 1)))
        sre, sim = complex_einsum_ri("bhex,bhey->bhxy", qre, qim, kre, kim)
        sre, sim = frequency_activation(sre, sim, self.activation)
        vre, vim = complex_einsum_ri("bhxy,bhey->bhex", sre, sim, kre, kim)
        out = irfft_ri(vre / self.denom, vim / self.denom, n=L)  # the bins past mq are zero
        return out.permute(0, 3, 2, 1).to(q.dtype), None


class MultiWaveletCross(nn.Module):
    """Multiwavelet cross attention: q, k and v projected to c x k
    coefficients (``Lq``, ``Lk``, ``Lv``), wavelet-decomposed, a Fourier
    cross attention per level (details by ``attn1`` + ``attn2``, smooth parts
    by ``attn3``, the coarsest by ``attn4``), even / odd reconstructed and
    projected back (``out``). q [B, N, H, E] -> ([B, N, ich], None)."""

    def __init__(self, in_channels: int, out_channels: int, seq_len_q: int, seq_len_kv: int,
                 modes: int, c: int = 64, k: int = 8, ich: int = 512, L: int = 0,
                 base: str = "legendre", activation: str = "tanh"):
        super().__init__()
        self.c, self.k, self.L = c, k, L
        self.filters = _FilterBank(base, k)
        self.Lq = Linear(ich, c * k)
        self.Lk = Linear(ich, c * k)
        self.Lv = Linear(ich, c * k)
        self.out = Linear(c * k, ich)
        for i in range(1, 5):
            setattr(self, f"attn{i}", FourierCrossAttentionW(in_channels, out_channels, modes,
                                                             activation))

    def forward(self, q, k, v, attn_mask=None, generator=None):
        B, N, H, E = q.shape
        S = k.shape[1]
        f, c, kk = self.filters, self.c, self.k
        q = self.Lq(q.reshape(B, N, -1)).reshape(B, N, c, kk)
        k = self.Lk(k.reshape(B, S, -1)).reshape(B, S, c, kk)
        v = self.Lv(v.reshape(B, S, -1)).reshape(B, S, c, kk)
        if N > S:
            pad = torch.zeros(B, N - S, c, kk, dtype=v.dtype, device=v.device)
            v = torch.cat([v, pad], dim=1)
            k = torch.cat([k, pad], dim=1)
        else:
            v, k = v[:, :N], k[:, :N]
        ns = math.floor(math.log2(N))
        q, k, v = pad_pow2(q), pad_pow2(k), pad_pow2(v)

        def decompose(x):
            levels = []
            for _ in range(ns - self.L):
                d, x = wavelet_transform(x, f.ec_d, f.ec_s)
                levels.append((d, x))
            return levels, x

        lq, q = decompose(q)
        lk, k = decompose(k)
        lv, v = decompose(v)
        Ud, Us = [], []
        for (dq, sq), (dk, sk), (dv, sv) in zip(lq, lk, lv):
            Ud.append(self.attn1(dq, dk, dv)[0] + self.attn2(sq, sk, sv)[0])
            Us.append(self.attn3(dq, dk, dv)[0])
        v = self.attn4(q, k, v)[0]
        for i in range(ns - 1 - self.L, -1, -1):
            v = torch.cat([v + Us[i], Ud[i]], dim=-1)
            v = even_odd(v, f.rc_e, f.rc_o, kk)
        return self.out(v[:, :N].reshape(B, N, -1)), None
