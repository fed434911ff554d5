"""The baselines' ops library in the port against the JAX package's, module
by module, on the CPU: the same inputs (a numpy seed) and the flax init's
weights (``weights.from_flax``), f32.

Tolerances: 1e-5 x max(1, max |JAX|) unless a test says otherwise; both
sides compute the same sums in other orders (the port's basis DFT and
gather-conv contract in one GEMM where JAX scans or einsums).
  - ``series_decomp`` at odd kernels, the moving average at an even one;
  - ``DataEmbedding`` with time features (``timeF``, the fixed and the
    learned calendar tables), ``_wo_pos`` and ``_wo_time``;
  - ``FullAttention`` (causal and not) through ``AttentionLayer`` and the
    ``Encoder``;
  - ``rfft_ri`` / ``irfft_ri`` at even and odd lengths, with a spectrum
    padded and one cut;
  - ``fold_conv2d`` at periods that divide T and periods that do not,
    and ``InceptionBlockV1``'s composite kernel;
  - ``fft_for_period``, on series whose k-th and (k+1)-th amplitudes lie a
    stated margin apart, so ``torch.topk`` and ``jax.lax.top_k`` pick the
    same periods (ties could be ordered apart);
  - ``FourierBlock``, ``FourierCrossAttention`` (tanh and softmax) and
    ``AutoCorrelation`` in its training and eval branches;
  - the wavelet filter bank (bit-equal: the port synthesizes it without
    sympy), ``get_phi_psi``, ``MultiWaveletTransform`` and
    ``MultiWaveletCross``;
  - ``get_frequency_modes`` under the same numpy seed;
  - each model's heads that no shipped file reaches (FEDformer's
    forecasting decoder among them), eval and train mode, and the state
    dict of FEDformer's Wavelets forecasting tree built on the meta device
    against ``jax.eval_shape`` of the flax init (its 200 M parameters stay
    unallocated).
"""

import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtsllm_tpu.config import Config as JaxConfig
from medtsllm_tpu.models import build_model as jax_build_model
from medtsllm_tpu.ops import attention as jatt
from medtsllm_tpu.ops import autocorr as jac
from medtsllm_tpu.ops import decomp as jdec
from medtsllm_tpu.ops import dft as jdft
from medtsllm_tpu.ops import embed as jemb
from medtsllm_tpu.ops import fourier as jfour
from medtsllm_tpu.ops import inception as jinc
from medtsllm_tpu.ops import transformer as jtf
from medtsllm_tpu.ops import wavelets as jwav
from medtsllm_tpu_torch.models import build_model
from medtsllm_tpu_torch.ops import attention as att
from medtsllm_tpu_torch.ops import autocorr as ac
from medtsllm_tpu_torch.ops import decomp as dec
from medtsllm_tpu_torch.ops import dft
from medtsllm_tpu_torch.ops import embed as emb
from medtsllm_tpu_torch.ops import fourier as four
from medtsllm_tpu_torch.ops import inception as inc
from medtsllm_tpu_torch.ops import transformer as tf
from medtsllm_tpu_torch.ops import wavelets as wav
from medtsllm_tpu_torch.weights import from_flax

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _close(got, want, tol=1e-5):
    """|got - want| <= tol x max(1, max |want|)."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def _jit(fn):
    """fn() under one ``jax.jit`` (eager flax compiles every op apart)."""
    return jax.jit(fn)()


def _load(module: torch.nn.Module, variables: dict) -> torch.nn.Module:
    """The flax variables' parameters into ``module``, whose state dict must
    have exactly their keys."""
    state = from_flax(jax.device_get(variables.get("params", {})))
    own = module.state_dict()
    assert set(state) == set(own), sorted(set(state) ^ set(own))
    module.load_state_dict(state)
    return module.eval()


# --------------------------------------------------------------------------
# decomposition, embeddings, attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", [25, 13, 24])
def test_series_decomp(kernel):
    """An even kernel's moving average is one step short, as in JAX and the
    reference (so only its moving average is held)."""
    x = _x(kernel, 3, 96, 7)
    _close(dec.moving_avg(_t(x), kernel), jdec.moving_avg(jnp.asarray(x), kernel))
    if kernel % 2 == 0:
        assert dec.moving_avg(_t(x), kernel).shape[1] == 95
        return
    for got, want in zip(dec.series_decomp(_t(x), kernel), jdec.series_decomp(jnp.asarray(x),
                                                                             kernel)):
        _close(got, want)
    for got, want in zip(dec.series_decomp_multi(_t(x), (kernel, 5)),
                         jdec.series_decomp_multi(jnp.asarray(x), (kernel, 5))):
        _close(got, want)
    _close(dec.my_layernorm_bias_correction(_t(x)),
           jdec.my_layernorm_bias_correction(jnp.asarray(x)))


@pytest.mark.parametrize("embed_type,freq", [("timeF", "h"), ("timeF", "s"), ("fixed", "h"),
                                             ("fixed", "t"), ("learned", "h")])
def test_data_embedding_with_time_features(embed_type, freq):
    """Value conv + positions + the time features' embedding."""
    B, L, C, D = 2, 24, 5, 16
    x = _x(1, B, L, C)
    if embed_type == "timeF":
        mark = _x(2, B, L, emb.TIME_FEATURES[freq])
    else:
        rng = np.random.default_rng(3)
        mark = np.stack([rng.integers(0, n, (B, L)) for _, n in emb.CALENDAR],
                        -1).astype(np.float32)
    jm = jemb.DataEmbedding(D, embed_type=embed_type, freq=freq, dropout=0.0)
    v = _jit(lambda: jm.init(KEY, jnp.asarray(x), jnp.asarray(mark)))
    tm = _load(emb.DataEmbedding(C, D, embed_type, freq, p=0.0, temporal=True), v)
    _close(tm(_t(x), _t(mark)), _jit(lambda: jm.apply(v, jnp.asarray(x), jnp.asarray(mark))))


def test_data_embedding_forms():
    B, L, C, D = 2, 20, 3, 8
    x = _x(4, B, L, C)
    for jcls, tm in ((jemb.DataEmbedding_wo_pos, emb.DataEmbedding_wo_pos(C, D, p=0.0)),
                     (jemb.DataEmbedding_wo_time, emb.DataEmbedding_wo_time(C, D, p=0.0))):
        jm = jcls(D, dropout=0.0)
        v = _jit(lambda: jm.init(KEY, jnp.asarray(x)))
        _close(_load(tm, v)(_t(x)), _jit(lambda: jm.apply(v, jnp.asarray(x))))


class _JaxEncoder(fnn.Module):
    """Two post-norm layers and the stack, scoped as PatchTST scopes them."""
    d: int
    causal: bool
    activation: str

    @fnn.compact
    def __call__(self, x):
        layers = tuple(jtf.EncoderLayer(
            jatt.AttentionLayer(jatt.FullAttention(mask_flag=self.causal,
                                                   attention_dropout=0.0), self.d, 4),
            self.d, 2 * self.d, dropout=0.0, activation=self.activation,
            name=f"encoder_layer_{i}") for i in range(2))
        return jtf.Encoder(layers, name="encoder")(x)[0]


class _Encoder(torch.nn.Module):
    def __init__(self, d, causal, activation):
        super().__init__()
        layers = []
        for i in range(2):
            attn = att.AttentionLayer(att.FullAttention(mask_flag=causal, p=0.0), d, 4)
            setattr(self, f"AttentionLayer_{i}", attn)
            layer = tf.EncoderLayer(attn, d, 2 * d, p=0.0, activation_name=activation)
            setattr(self, f"encoder_layer_{i}", layer)
            layers.append(layer)
        self.encoder = tf.Encoder(layers, d)

    def forward(self, x):
        return self.encoder(x)[0]


@pytest.mark.parametrize("causal,activation", [(False, "gelu"), (True, "relu")])
def test_full_attention_encoder(causal, activation):
    x = _x(5, 3, 12, 16)
    jm = _JaxEncoder(16, causal, activation)
    v = _jit(lambda: jm.init(KEY, jnp.asarray(x)))
    _close(_load(_Encoder(16, causal, activation), v)(_t(x)),
           _jit(lambda: jm.apply(v, jnp.asarray(x))))
    q, k = _x(6, 2, 7, 4, 8), _x(7, 2, 9, 4, 8)
    out, A = att.FullAttention(mask_flag=False, p=0.0, output_attention=True).eval()(
        _t(q), _t(k), _t(k))
    jout, jA = _jit(lambda: jatt.FullAttention(mask_flag=False, output_attention=True).apply(
        {}, jnp.asarray(q), jnp.asarray(k), jnp.asarray(k)))
    _close(out, jout)
    _close(A, jA)


# --------------------------------------------------------------------------
# DFT, the folded conv, the period
# --------------------------------------------------------------------------

@pytest.mark.parametrize("L", [32, 33, 100])
def test_rfft_irfft(L):
    x = _x(L, 3, 5, L)
    re, im = dft.rfft_ri(_t(x))
    jre, jim = jdft.rfft_ri(jnp.asarray(x))
    _close(re, jre)
    _close(im, jim)
    for n in (L, L // 2, 2 * L):  # the spectrum as it is, cut, zero-padded
        _close(dft.irfft_ri(re, im, n), jdft.irfft_ri(jre, jim, n))
    _close(dft.irfft_ri(re, im, L), x, 1e-5)  # the round trip


@pytest.mark.parametrize("T,period", [(24, 6), (24, 24), (24, 1), (24, 5), (24, 7), (25, 10)])
def test_fold_conv2d(T, period):
    """One stage over the 2T buffer (the raw series, zeros behind it) and a
    final one over T, at periods that divide T and periods that do not."""
    B, Nin, Nout, K = 2, 3, 4, 5
    x = np.concatenate([_x(T, B, T, Nin), np.zeros((B, T, Nin), np.float32)], 1)
    kernel, bias = _x(1, K, K, Nin, Nout), _x(2, Nout)
    p_t, p_j = torch.tensor(period), jnp.asarray(period)
    for out_len in (2 * T, T):
        got = inc.fold_conv2d(_t(x), p_t, _t(kernel), _t(bias), seq_len=T, out_len=out_len)
        want = _jit(lambda: jinc.fold_conv2d(jnp.asarray(x), p_j, jnp.asarray(kernel),
                                             jnp.asarray(bias), seq_len=T, out_len=out_len))
        _close(got, want)
    assert inc.fold_conv_valid_mask(2 * T, T, p_t).tolist() == np.asarray(
        jinc.fold_conv_valid_mask(2 * T, T, p_j)).tolist()


def test_inception_block_v1():
    """The composite kernel of 6 parallel kernels (1 ... 11), at a period
    that does not divide T; the kernels keep the flax layout and names."""
    T, Nin, Nout = 30, 4, 6
    x = np.concatenate([_x(8, 2, T, Nin), np.zeros((2, T, Nin), np.float32)], 1)
    jm = jinc.InceptionBlockV1(Nout, num_kernels=6)
    v = _jit(lambda: jm.init(KEY, jnp.asarray(x), jnp.asarray(7), seq_len=T, out_len=2 * T))
    tm = _load(inc.InceptionBlockV1(Nin, Nout, 6), v)
    assert tuple(tm.kernel_5.shape) == (11, 11, Nin, Nout)
    _close(tm(_t(x), torch.tensor(7), seq_len=T, out_len=2 * T),
           _jit(lambda: jm.apply(v, jnp.asarray(x), jnp.asarray(7), seq_len=T, out_len=2 * T)))


@pytest.mark.parametrize("T,k", [(96, 3), (100, 2)])
def test_fft_for_period(T, k):
    """Sinusoids at k + 1 frequencies of falling amplitude plus noise: the
    k-th largest mean amplitude exceeds the (k+1)-th by at least 20% of
    it (asserted on the input), so both top-k pick the same bins."""
    B, N = 3, 4
    rng = np.random.default_rng(T)
    t = np.arange(T)[None, :, None]
    freqs = rng.choice(np.arange(1, T // 2), k + 1, replace=False)
    x = sum((k + 2 - i) * np.sin(2 * np.pi * f * t / T + rng.uniform(0, 6, (B, 1, N)))
            for i, f in enumerate(freqs)) + 0.1 * rng.standard_normal((B, T, N))
    x = x.astype(np.float32)
    amp = np.abs(np.fft.rfft(x, axis=1)).mean(axis=(0, 2))
    amp[0] = 0
    top = np.sort(amp)[::-1]
    assert top[k - 1] >= 1.2 * top[k], "the input's top-k margin"
    periods, weight = inc.fft_for_period(_t(x), k)
    jperiods, jweight = _jit(lambda: jinc.fft_for_period(jnp.asarray(x), k))
    assert periods.tolist() == np.asarray(jperiods).tolist()
    _close(weight, jweight)


# --------------------------------------------------------------------------
# Fourier blocks and auto-correlation
# --------------------------------------------------------------------------

def test_frequency_modes_match_jax():
    for method in ("random", "low"):
        for L, m in ((96, 32), (40, 64), (128, 8)):
            np.random.seed(L)
            want = jfour.get_frequency_modes(L, m, method)
            np.random.seed(L)
            assert four.get_frequency_modes(L, m, method) == want


def test_fourier_block():
    B, L, H, E = 2, 32, 4, 4
    index = tuple(sorted(np.random.default_rng(0).choice(16, 6, replace=False).tolist()))
    q = _x(9, B, L, H, E)
    jm = jfour.FourierBlock(H * E, H * E, L, index, n_heads=H)
    v = _jit(lambda: jm.init(KEY, jnp.asarray(q), jnp.asarray(q), jnp.asarray(q)))
    tm = _load(four.FourierBlock(H * E, H * E, L, index, H), v)
    _close(tm(_t(q), _t(q), _t(q))[0], _jit(lambda: jm.apply(v, *[jnp.asarray(q)] * 3)[0]))


@pytest.mark.parametrize("activation", ["tanh", "softmax"])
def test_fourier_cross_attention(activation):
    B, Lq, Lkv, H, E = 2, 24, 32, 4, 4
    iq, ikv = (1, 3, 4, 7), (0, 2, 5, 9)
    q, k = _x(10, B, Lq, H, E), _x(11, B, Lkv, H, E)
    jm = jfour.FourierCrossAttention(H * E, H * E, Lq, Lkv, iq, ikv, activation=activation,
                                     num_heads=H)
    v = _jit(lambda: jm.init(KEY, jnp.asarray(q), jnp.asarray(k), jnp.asarray(k)))
    tm = _load(four.FourierCrossAttention(H * E, H * E, Lq, Lkv, iq, ikv, activation, H), v)
    _close(tm(_t(q), _t(k), _t(k))[0],
           _jit(lambda: jm.apply(v, jnp.asarray(q), jnp.asarray(k), jnp.asarray(k))[0]))


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("S", [32, 20, 40])
def test_autocorrelation(training, S):
    """The training branch (delays shared over the batch) and the eval
    branch (per row), keys shorter, as long as and longer than queries."""
    B, L, H, E = 3, 32, 2, 4
    q, k, v = _x(12, B, L, H, E), _x(13, B, S, H, E), _x(14, B, S, H, E)
    m = ac.AutoCorrelation(factor=1, output_attention=True).train(training)
    out, corr = m(_t(q), _t(k), _t(v))
    jout, jcorr = _jit(lambda: jac.AutoCorrelation(factor=1, output_attention=True).apply(
        {}, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), deterministic=not training))
    _close(out, jout)
    _close(corr, jcorr)
    delays = torch.tensor([[3, 7], [0, 31], [5, 5]])
    vals = _t(_x(15, B, H, E, L))
    want = jac._delay_gather(jnp.asarray(vals.numpy()), jnp.asarray(delays.numpy()))
    assert torch.equal(ac.delay_gather(vals, delays), torch.from_numpy(np.array(want)))


# --------------------------------------------------------------------------
# multiwavelets
# --------------------------------------------------------------------------

@pytest.mark.parametrize("base", ["legendre", "chebyshev"])
@pytest.mark.parametrize("k", [3, 8])
def test_filter_bank_bit_equal(base, k):
    """The float32 filters bit-equal to the sympy-built ones; the float64
    filters and the polynomials within 1e-12 (the port's exact
    coefficients and polished roots against sympy's)."""
    for got, want in zip(wav.filter_bank(base, k), jwav.filter_bank(base, k)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    for got, want in zip(wav.get_filter(base, k), jwav.get_filter(base, k)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    grid = np.linspace(0, 1, 41)
    for fam_t, fam_j in zip(wav.get_phi_psi(k, base), jwav.get_phi_psi(k, base)):
        for f_t, f_j in zip(fam_t, fam_j):
            np.testing.assert_allclose(f_t(grid), f_j(grid), rtol=0, atol=1e-9)


def test_multiwavelet_transform():
    B, L, H, E = 2, 24, 4, 4
    q = _x(16, B, L, H, E)
    v_in = _x(17, B, 16, H, E)  # values shorter than the queries: zero-padded
    jm = jwav.MultiWaveletTransform(ich=H * E, k=3, alpha=4, c=4, nCZ=2, L=1)
    v = _jit(lambda: jm.init(KEY, jnp.asarray(q), jnp.asarray(q), jnp.asarray(v_in)))
    tm = _load(wav.MultiWaveletTransform(ich=H * E, k=3, alpha=4, c=4, nCZ=2, L=1), v)
    _close(tm(_t(q), _t(q), _t(v_in))[0],
           _jit(lambda: jm.apply(v, jnp.asarray(q), jnp.asarray(q), jnp.asarray(v_in))[0]))


@pytest.mark.parametrize("S", [16, 40])
def test_multiwavelet_cross(S):
    B, Nq, H, E = 2, 24, 4, 4
    q, k = _x(18, B, Nq, H, E), _x(19, B, S, H, E)
    kw = dict(in_channels=16, out_channels=16, seq_len_q=Nq, seq_len_kv=S, modes=4, c=4, k=3,
              ich=H * E, L=0)
    jm = jwav.MultiWaveletCross(**kw)
    v = _jit(lambda: jm.init(KEY, jnp.asarray(q), jnp.asarray(k), jnp.asarray(k)))
    tm = _load(wav.MultiWaveletCross(**kw), v)
    _close(tm(_t(q), _t(k), _t(k))[0],
           _jit(lambda: jm.apply(v, jnp.asarray(q), jnp.asarray(k), jnp.asarray(k))[0]))


# --------------------------------------------------------------------------
# the models' heads that no shipped file reaches
# --------------------------------------------------------------------------

MODELS = {
    "dlinear": {"individual": False, "moving_avg": 13},
    "dlinear-individual": {"individual": True, "moving_avg": 13},
    "patchtst": {"e_layers": 1, "d_model": 16, "d_ff": 32, "n_heads": 4,
                 "covariate_mode": "independent", "patching": {"patch_len": 8, "stride": 4}},
    "timesnet": {"e_layers": 1, "d_model": 8, "d_ff": 8, "num_kernels": 3, "top_k": 2},
    "fedformer": {"version": "fourier", "mode_select": "random", "modes": 4, "label_len": 16,
                  "e_layers": 1, "d_layers": 1, "d_model": 16, "n_heads": 4, "d_ff": 32,
                  "moving_avg": 13, "activation": "gelu"},
}
# (model, task, classes): the heads, and the one DLinear variant, that no
# shipped file reaches
HEADS = [("dlinear", "semantic_segmentation", 4), ("dlinear", "segmentation", 0),
         ("dlinear-individual", "forecasting", 0),
         ("patchtst", "forecasting", 0), ("patchtst", "semantic_segmentation", 3),
         ("patchtst", "imputation", 0),
         ("timesnet", "forecasting", 0), ("timesnet", "classification", 3),
         ("timesnet", "semantic_segmentation", 4),
         ("fedformer", "forecasting", 0), ("fedformer", "classification", 2),
         ("fedformer", "semantic_segmentation", 4)]


def _model_config(name, task, n_classes):
    model = name.split("-")[0]
    pred = 16 if task == "forecasting" else 32
    return JaxConfig({
        "task": task, "model": model, "history_len": 32, "pred_len": pred,
        "training": {"dropout": 0.0},
        "tasks": {"segmentation": {"mode": "boundary-prediction"}},
        "models": {model: MODELS[name]}})


@pytest.mark.parametrize("name,task,n_classes", HEADS,
                         ids=[f"{m}-{t}-{c}" for m, t, c in HEADS])
def test_model_heads(name, task, n_classes):
    """Eval (the sigmoid / softmax heads) and train mode (dropout 0), the
    flax tree's keys."""
    cfg = _model_config(name, task, n_classes)
    ds = types.SimpleNamespace(n_features=3, n_classes=n_classes)
    np.random.seed(0)
    jm = jax_build_model(cfg, ds)
    np.random.seed(0)
    tm = build_model(cfg, ds, torch.device("cpu"))
    x = _x(20, 2, 32, 3)
    inputs = {"x_enc": jnp.asarray(x)}
    if task == "imputation":
        inputs["mask"] = jnp.asarray((np.random.default_rng(1).random(x.shape) > 0.3)
                                     .astype(np.float32))
        inputs["x_enc"] = inputs["x_enc"] * inputs["mask"]
    v = _jit(lambda: jm.init({"params": KEY, "dropout": KEY}, inputs, training=False))
    _load(tm, v)
    t_in = {k: _t(a) for k, a in inputs.items()}
    wants = _jit(lambda: [jm.apply(v, inputs, training=t) for t in (False, True)])
    for training, want in zip((False, True), wants):
        _close(tm.train(training)(t_in), want)


def test_fedformer_wavelets_forecasting_tree():
    """FEDformer Wavelets for forecasting (two multiwavelet transforms and
    the cross block, 128 x 8 coefficients each): the port's state dict,
    built on the meta device, has the keys and shapes of the flax tree
    (``jax.eval_shape`` of its init)."""
    mc = dict(MODELS["fedformer"], version="Wavelets", d_layers=2)
    cfg = JaxConfig({"task": "forecasting", "model": "fedformer", "history_len": 32,
                     "pred_len": 16, "training": {"dropout": 0.0}, "tasks": {},
                     "models": {"fedformer": mc}})
    ds = types.SimpleNamespace(n_features=3, n_classes=0)
    jm = jax_build_model(cfg, ds)
    inputs = {"x_enc": jnp.zeros((2, 32, 3), jnp.float32)}
    shapes = jax.eval_shape(lambda: jm.init({"params": KEY}, inputs, training=False))["params"]
    flat = {"/".join(p.key for p in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    # the 64 MB spectral weights keep their names and layout in from_flax:
    # zero-size stand-ins give their names, the flax shapes their shapes
    big = {k for k, shape in flat.items() if np.prod(shape) >= 2 ** 20}
    assert big and all(k.rsplit("/", 1)[1] in ("weights1", "weights2") for k in big)
    names = from_flax({k: np.empty((0,) * len(shape) if k in big else shape, np.float32)
                       for k, shape in flat.items()})
    want = {name: tuple(flat[k]) if k in big else tuple(t.shape)
            for k, (name, t) in zip(flat, names.items())}
    with torch.device("meta"):
        tm = build_model(cfg, ds, torch.device("meta"))
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want
    assert sum(np.prod(shape) for shape in got.values()) > 2e8
