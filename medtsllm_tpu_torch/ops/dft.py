"""The real DFT as a matmul over a basis (port of ``medtsllm_tpu/ops/dft.py``:
``rfft_ri``, ``irfft_ri``, ``complex_einsum_ri`` and the complex ``rfft`` /
``irfft``).

Spectra are (re, im) pairs of real tensors. The transform is a GEMM over a
cos / sin basis built in float64 on the host and kept on the device
(``device_constant``), as JAX builds it, rather than ``torch.fft``: the
frequency models run it on a few hundred steps, where one GEMM is cheap,
the numbers are the JAX package's up to the GEMM's summation order (the
period that TimesNet picks from them then agrees), and a captured step
holds no cuFFT plan. This is no Pallas kernel's port: JAX computes it as
XLA dots.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import device_constant

SEQ_CUTOFF = 2048  # past this length the complex forms take torch.fft, as JAX takes jnp.fft


def _rfft_basis(L: int) -> np.ndarray:
    """[2, L, L // 2 + 1]: cos and sin of -2 pi t k / L."""
    t = np.arange(L)[:, None]
    k = np.arange(L // 2 + 1)[None, :]
    ang = -2.0 * np.pi * t * k / L
    return np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)


def _irfft_basis(F: int, n: int) -> np.ndarray:
    """[2, F, n]: the inverse's weights for the real and imaginary parts."""
    k = np.arange(F)[:, None]
    t = np.arange(n)[None, :]
    w = np.full(F, 2.0)
    w[0] = 1.0
    if n % 2 == 0 and F == n // 2 + 1:
        w[-1] = 1.0
    ang = 2.0 * np.pi * k * t / n
    return np.stack([w[:, None] * np.cos(ang) / n,
                     -w[:, None] * np.sin(ang) / n]).astype(np.float32)


def _matmul_last(x: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """x [..., L] @ basis [L, F] as one 2-D GEMM."""
    lead = x.shape[:-1]
    return (x.reshape(-1, x.shape[-1]) @ basis).reshape(*lead, basis.shape[-1])


def rfft_ri(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Real signal -> its spectrum over the last axis, (re, im) in f32."""
    L = x.shape[-1]
    basis = device_constant(("rfft", L), lambda: _rfft_basis(L), x.device)
    xf = x.float()
    return _matmul_last(xf, basis[0]), _matmul_last(xf, basis[1])


def irfft_ri(re: torch.Tensor, im: torch.Tensor, n: int) -> torch.Tensor:
    """(re, im) spectrum -> the real signal of length n (last axis); a
    shorter spectrum is zero-padded to n // 2 + 1 bins, a longer one cut."""
    F_needed = n // 2 + 1
    F = re.shape[-1]
    if F < F_needed:
        re = torch.nn.functional.pad(re, (0, F_needed - F))
        im = torch.nn.functional.pad(im, (0, F_needed - F))
    elif F > F_needed:
        re, im = re[..., :F_needed], im[..., :F_needed]
    basis = device_constant(("irfft", n), lambda: _irfft_basis(F_needed, n), re.device)
    return _matmul_last(re.float(), basis[0]) + _matmul_last(im.float(), basis[1])


def complex_einsum_ri(order: str, are, aim, bre, bim):
    """einsum(order, a, b) for (re, im) pairs: four real einsums."""
    return (torch.einsum(order, are, bre) - torch.einsum(order, aim, bim),
            torch.einsum(order, are, bim) + torch.einsum(order, aim, bre))


def rfft(x: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """``jnp.fft.rfft`` over the last axis, x zero-padded or cut to ``n``:
    the complex spectrum of the basis GEMM, or of ``torch.fft`` past
    ``SEQ_CUTOFF`` steps."""
    L = x.shape[-1]
    if n is not None and n != L:
        x = torch.nn.functional.pad(x, (0, n - L)) if n > L else x[..., :n]
    if x.shape[-1] > SEQ_CUTOFF:
        return torch.fft.rfft(x.float())
    return torch.complex(*rfft_ri(x))


def irfft(spec: torch.Tensor, n: int) -> torch.Tensor:
    """``jnp.fft.irfft`` over the last axis: the real signal of length n
    (the spectrum zero-padded or cut to n // 2 + 1 bins), f32."""
    if n > SEQ_CUTOFF:
        return torch.fft.irfft(spec, n=n).float()  # pads or cuts the bins itself
    return irfft_ri(spec.real, spec.imag, n)
