"""TimesNet's period-folded 2-D convolution (port of
``medtsllm_tpu/ops/inception.py``: ``fold_conv2d``,
``fold_conv_valid_mask``, ``InceptionBlockV1`` and ``fft_for_period``).

The reference folds the series into a [cycles x period] image, its width
a period read back to the host every forward. As in JAX, the period here
stays a device tensor: a K x K conv at the folded image's (i, j) reads
x[t + di * p + dj] with t = i * p + j, so the folded conv is a 1-D
gather-conv with taps at offsets di * p + dj, masked where the image's
zero padding lies. The step makes no host read and is captured as one
CUDA graph. JAX accumulates the taps one by one in a scan; the port
gathers all K * K taps at once ([B, out_len, K * K * Nin], by a one-hot
GEMM) and contracts them in one GEMM with the kernel, which is the same
sum in another order.

``InceptionBlockV1``'s parallel odd kernels all map Nin -> Nout and are
averaged, so they collapse into one composite K_max x K_max kernel. Its
``kernel_{i}`` parameters keep the flax layout [K, K, Nin, Nout] under the
flax names (``weights.from_flax`` converts only 2- and 3-D ``kernel``
leaves). ``InceptionBlockV2``'s separable 1 x K and K x 1 kernels and its
1 x 1 kernel compose into one such kernel the same way, and keep their
flax layouts ([1, K, Nin, Nout], [K, 1, Nin, Nout], [1, 1, Nin, Nout]).
"""

from __future__ import annotations

import torch
from torch import nn

from .dft import rfft_ri


def fold_conv2d(x: torch.Tensor, period: torch.Tensor, kernel: torch.Tensor,
                bias: torch.Tensor, seq_len: int | None = None,
                out_len: int | None = None) -> torch.Tensor:
    """The composite-kernel 2-D conv on the period-folded view of a buffer.

    x [B, Lbuf, Nin]: the folded image flattened row-major, valid at
    [0, total), total = ceil(seq_len / period) * period (zeros at
    [seq_len, Lbuf) when it holds the raw series; an intermediate buffer
    masked beyond ``total`` by ``fold_conv_valid_mask``); ``period`` a 0-d
    int device tensor; kernel [K, K, Nin, Nout] (K odd, zero 'same'
    padding on the folded image); bias [Nout]; ``seq_len`` the series
    length T (default Lbuf); ``out_len`` the positions produced (default
    Lbuf; T at the last stage, 2T between stages, since the reference's
    second conv reads the first one's padded rows)."""
    B, Lbuf, Nin = x.shape
    T = seq_len if seq_len is not None else Lbuf
    out_len = out_len if out_len is not None else Lbuf
    K = kernel.shape[0]
    c = K // 2
    Nout = kernel.shape[-1]
    dev = x.device

    p = period.to(torch.int64)
    t = torch.arange(out_len, device=dev)
    total = torch.div(T + p - 1, p, rounding_mode="floor") * p
    # the taps in the kernel's [K, K] order: di major, dj minor
    d = torch.arange(-c, c + 1, device=dev)
    di, dj = d.repeat_interleave(K)[:, None], d.repeat(K)[:, None]
    s = t[None] + di * p + dj  # [taps, out_len]
    jj = torch.remainder(t, p)[None] + dj
    valid = (jj >= 0) & (jj < p) & (s >= 0) & (s < total) & (s < Lbuf)
    # the gather as one 2-D one-hot GEMM, [B * Nin, Lbuf] @ [Lbuf, taps *
    # out_len]: exact in the forward, and its backward is a GEMM, not
    # index_add's atomics, so a step's gradients repeat bit for bit
    onehot = (torch.arange(Lbuf, device=dev)[:, None, None] == s) & valid  # [Lbuf, taps, out]
    vals = x.transpose(1, 2).reshape(B * Nin, Lbuf) @ onehot.to(x.dtype).reshape(Lbuf, -1)
    vals = vals.reshape(B, Nin, K * K, out_len).permute(0, 3, 2, 1)  # [B, out, taps, Nin]
    w = kernel.to(x.dtype).reshape(K * K * Nin, Nout)
    out = vals.reshape(B, out_len, K * K * Nin) @ w
    return out + bias.to(x.dtype)


def fold_conv_valid_mask(out_len: int, seq_len: int, period: torch.Tensor) -> torch.Tensor:
    """[out_len] bool: the positions inside the padded image
    (< ceil(seq_len / period) * period)."""
    p = period.to(torch.int64)
    total = torch.div(seq_len + p - 1, p, rounding_mode="floor") * p
    return torch.arange(out_len, device=period.device) < total


class InceptionBlockV1(nn.Module):
    """Parallel 2-D convs of kernel 1, 3, ..., 2 * num_kernels - 1, averaged,
    on the folded grid through one composite kernel."""

    def __init__(self, in_channels: int, out_channels: int, num_kernels: int = 6):
        super().__init__()
        self.num_kernels = num_kernels
        for i in range(num_kernels):
            K = 2 * i + 1
            setattr(self, f"kernel_{i}",
                    nn.Parameter(torch.empty(K, K, in_channels, out_channels)))
            setattr(self, f"bias_{i}", nn.Parameter(torch.zeros(out_channels)))

    def composite_kernel(self, dtype: torch.dtype):
        """(the K_max x K_max kernel, the bias): each kernel zero-padded to
        K_max and summed, then both over num_kernels."""
        kernel, bias = 0, 0
        for i in range(self.num_kernels):
            pad = self.num_kernels - 1 - i
            w = getattr(self, f"kernel_{i}").to(dtype)
            kernel = kernel + torch.nn.functional.pad(w, (0, 0, 0, 0, pad, pad, pad, pad))
            bias = bias + getattr(self, f"bias_{i}")
        return kernel / self.num_kernels, bias / self.num_kernels

    def forward(self, x, period, seq_len: int | None = None, out_len: int | None = None):
        kernel, bias = self.composite_kernel(x.dtype)
        return fold_conv2d(x, period, kernel, bias, seq_len=seq_len, out_len=out_len)


class InceptionBlockV2(nn.Module):
    """Separable 1 x K and K x 1 kernels (K = 3, 5, ..., num_kernels // 2
    of each) and a 1 x 1 kernel, averaged over the 2 (num_kernels // 2) + 1
    branches, on the folded grid through one composite kernel."""

    def __init__(self, in_channels: int, out_channels: int, num_kernels: int = 6):
        super().__init__()
        self.num_kernels = num_kernels
        for i in range(num_kernels // 2):
            K = 2 * i + 3
            for kind, shape in (("row", (1, K)), ("col", (K, 1))):
                setattr(self, f"{kind}_kernel_{i}",
                        nn.Parameter(torch.empty(*shape, in_channels, out_channels)))
                setattr(self, f"{kind}_bias_{i}", nn.Parameter(torch.zeros(out_channels)))
        self.one_kernel = nn.Parameter(torch.empty(1, 1, in_channels, out_channels))
        self.one_bias = nn.Parameter(torch.zeros(out_channels))

    def composite_kernel(self, dtype: torch.dtype):
        """(the K_max x K_max kernel, the bias), summed in JAX's order: each
        i's row then column kernel, then the 1 x 1, over the branches."""
        c = self.num_kernels // 2
        kernel, bias = 0, 0
        for i in range(c):
            pad = c - 1 - i
            row = getattr(self, f"row_kernel_{i}").to(dtype)
            col = getattr(self, f"col_kernel_{i}").to(dtype)
            kernel = kernel + torch.nn.functional.pad(row, (0, 0, 0, 0, pad, pad, c, c))
            kernel = kernel + torch.nn.functional.pad(col, (0, 0, 0, 0, c, c, pad, pad))
            bias = bias + getattr(self, f"row_bias_{i}") + getattr(self, f"col_bias_{i}")
        kernel = kernel + torch.nn.functional.pad(self.one_kernel.to(dtype),
                                                  (0, 0, 0, 0, c, c, c, c))
        n = 2 * c + 1
        return kernel / n, (bias + self.one_bias) / n

    def forward(self, x, period, seq_len: int | None = None, out_len: int | None = None):
        kernel, bias = self.composite_kernel(x.dtype)
        return fold_conv2d(x, period, kernel, bias, seq_len=seq_len, out_len=out_len)


def fft_for_period(x: torch.Tensor, k: int = 2):
    """The top-k periods of x [B, T, N] by rFFT amplitude, averaged over
    the batch and the channels (the DC bin left out), as device tensors:
    (periods [k] = T // frequency, their amplitudes per row [B, k])."""
    re, im = rfft_ri(x.float().transpose(1, 2))
    amp = torch.sqrt(re * re + im * im).transpose(1, 2)  # [B, F, N]
    freq = amp.mean(dim=0).mean(dim=-1)
    freq = torch.cat([torch.zeros_like(freq[:1]), freq[1:]])
    top = torch.topk(freq, k).indices
    period = x.shape[1] // top.clamp(min=1)
    weight = amp.mean(dim=-1)[:, top]
    return period, weight
