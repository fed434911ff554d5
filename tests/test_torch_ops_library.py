"""The ops library that no model reaches, in the port against the JAX
package's, on the CPU: the same inputs (a numpy seed) and the flax init's
weights (``weights.from_flax``, with ``batch_stats`` for the BatchNorm),
f32, eval unless a test says otherwise.

Tolerance: 1e-5 x max(1, max |JAX|) (gradients: per tensor), both sides
computing the same sums in other orders; bucket ids, masks and sample
indices exactly. The JAX references run under ``jax.jit``; a module shared
by several tests is built once (module-scoped fixtures).
  - ``prob_mask``; ``FullAttention`` (``tau`` / ``delta`` passed and
    ignored), ``DSAttention`` with and without them, causal and not;
    ``ProbAttention`` at full coverage and at u < L_Q (factor 1, L 32),
    causal and not, through ``AttentionLayer``;
  - ``ProbAttention``'s key sample against ``jnp.linspace(...).astype(
    int32)`` over L_K 2 ... 4096 at factors 1, 3 and 5 (eager, and under
    ``jax.jit`` where the sample is a compile-time constant);
  - Informer (a 2-layer ``ProbAttention`` encoder with a ``ConvLayer``
    between the layers, then a ``Decoder`` with a causal ``ProbAttention``
    and a ``FullAttention`` cross-attention) and the Non-stationary
    Transformer's form (``DSAttention`` throughout, ``tau`` / ``delta``),
    whole; the ``Decoder``'s gradients against ``jax.grad``;
  - ``ConvLayer`` on non-trivial running averages, in eval and in
    training (flax's BatchNorm keeps the running averages in both);
  - ``ReformerLayer`` with JAX's rotations fed in, at N a multiple of 2 x
    bucket_size and not: bucket ids equal, outputs, gradients; the four
    properties of ``tests/test_lsh_attention.py`` on the port's own
    draws; the port's default draws;
  - ``TwoStageAttentionLayer``, ``InceptionBlockV2``, ``FlattenHead``,
    ``RevINAffine`` and the complex ``rfft`` / ``irfft``;
  - the names ``medtsllm_tpu_torch.ops`` exports, and ``init_random_``'s
    distributions for the new parameters.
"""

import math
import zlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medtsllm_tpu.ops as jops
import medtsllm_tpu_torch.ops as ops
from medtsllm_tpu.ops import attention as jatt
from medtsllm_tpu.ops import crossformer as jcf
from medtsllm_tpu.ops import dft as jdft
from medtsllm_tpu.ops import heads as jheads
from medtsllm_tpu.ops import inception as jinc
from medtsllm_tpu.ops import lsh_attention as jlsh
from medtsllm_tpu.ops import masks as jmasks
from medtsllm_tpu.ops import revin as jrevin
from medtsllm_tpu.ops import transformer as jtf
from medtsllm_tpu_torch.ops import attention as att
from medtsllm_tpu_torch.ops import crossformer as cf
from medtsllm_tpu_torch.ops import dft
from medtsllm_tpu_torch.ops import heads
from medtsllm_tpu_torch.ops import inception as inc
from medtsllm_tpu_torch.ops import lsh_attention as lsh
from medtsllm_tpu_torch.ops import masks
from medtsllm_tpu_torch.ops import revin
from medtsllm_tpu_torch.ops import transformer as tf
from medtsllm_tpu_torch.weights import from_flax, init_random_

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy()).requires_grad_(grad)


def _close(got, want, tol=1e-5):
    """|got - want| <= tol x max(1, max |want|)."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def _jit(fn):
    """fn() under one ``jax.jit``."""
    return jax.jit(fn)()


def _load(module: torch.nn.Module, variables: dict) -> torch.nn.Module:
    """The flax variables (params and batch_stats) into ``module``, whose
    state dict must have exactly their keys."""
    state = from_flax(jax.device_get(variables.get("params", {})),
                      jax.device_get(variables.get("batch_stats")))
    own = module.state_dict()
    assert set(state) == set(own), sorted(set(state) ^ set(own))
    module.load_state_dict(state)
    return module.eval()


def _grads_close(module, jax_param_grads, inputs, input_grads):
    """Each parameter's gradient (by its flax path) and each input's."""
    want = from_flax(jax.device_get(jax_param_grads))
    got = {k: p.grad for k, p in module.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])
    for t, g in zip(inputs, input_grads):
        _close(t.grad, g)


# --------------------------------------------------------------------------
# masks and the inner attentions
# --------------------------------------------------------------------------

def test_prob_mask():
    index = np.random.default_rng(0).integers(0, 12, (2, 3, 5))
    got = masks.prob_mask(12, torch.from_numpy(index), (2, 3, 5, 10))
    want = jmasks.prob_mask(12, jnp.asarray(index), (2, 3, 5, 10))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), np.asarray(want))


# (inner attention, mask_flag, factor, L = S): ProbAttention at factor 64
# covers every query and key; at factor 1 and L 32 u = U = 4 < 32
INNER = [("full", True, None, 12), ("ds", False, None, 12), ("ds", True, None, 12),
         ("prob", False, 64, 16), ("prob", True, 64, 16), ("prob", False, 1, 32),
         ("prob", True, 1, 32)]


def _inner(kind, mask_flag, factor):
    if kind == "prob":
        return (jatt.ProbAttention(mask_flag=mask_flag, factor=factor, attention_dropout=0.0),
                att.ProbAttention(mask_flag=mask_flag, factor=factor, p=0.0))
    jcls, tcls = {"full": (jatt.FullAttention, att.FullAttention),
                  "ds": (jatt.DSAttention, att.DSAttention)}[kind]
    return jcls(mask_flag=mask_flag, attention_dropout=0.0), tcls(mask_flag=mask_flag, p=0.0)


@pytest.mark.parametrize("kind,mask_flag,factor,L", INNER,
                         ids=[f"{k}-{'causal' if m else 'full'}-{f}-{L}" for k, m, f, L in INNER])
def test_inner_attention_through_attention_layer(kind, mask_flag, factor, L):
    """With ``tau`` [B] and ``delta`` [B, S] (only DSAttention reads them)
    and, for DSAttention, without them."""
    B, d, H = 2, 16, 4
    x = _x(L, B, L, d)
    tau = np.abs(_x(1, B)) + 0.5
    delta = _x(2, B, L)
    jinner, tinner = _inner(kind, mask_flag, factor)
    jm = jatt.AttentionLayer(jinner, d, H)
    v = _jit(lambda: jm.init(KEY, *[jnp.asarray(x)] * 3))
    tm = _load(att.AttentionLayer(tinner, d, H), v)
    cases = [(tau, delta)] + ([(None, None)] if kind == "ds" else [])
    for ta, de in cases:
        jt_, jd_ = (None if a is None else jnp.asarray(a) for a in (ta, de))
        want = _jit(lambda: jm.apply(v, *[jnp.asarray(x)] * 3, None, jt_, jd_)[0])
        got = tm(*[_t(x)] * 3, tau=None if ta is None else _t(ta),
                 delta=None if de is None else _t(de))[0]
        _close(got, want)


def test_prob_attention_select_and_index():
    """``select`` picks the u queries of the largest measure (numpy's
    argsort of it); ``index`` set to them changes nothing, and another
    index gives another output."""
    B, L, H, D = 2, 32, 4, 8
    q, k, v = (_t(_x(s, B, L, H, D)) for s in (30, 31, 32))
    m = att.ProbAttention(mask_flag=True, factor=1, p=0.0).eval()
    index = m.select(q, k)
    samp = att.prob_sample_index(L, 4)
    s_ = np.einsum("blhd,buhd->bhlu", q.numpy(), k.numpy()[:, samp])
    M = s_.max(-1) - s_.sum(-1) / L
    want = np.sort(np.argsort(-M, axis=-1)[..., :4], -1)
    assert np.array_equal(np.sort(index.numpy(), -1), want)
    out = m(q, k, v)[0]
    torch.testing.assert_close(m(q, k, v, index=index)[0], out, rtol=0, atol=0)
    assert not torch.allclose(m(q, k, v, index=(index + 1) % L)[0], out)


# --------------------------------------------------------------------------
# ProbAttention's key sample
# --------------------------------------------------------------------------

def _sample_pairs():
    return sorted({(L_K, min(int(f * math.ceil(math.log(L_K))), L_K))
                   for f in (1, 3, 5) for L_K in range(2, 4097)})


def test_prob_sample_index_matches_jnp_linspace():
    """Every (L_K, U_part) that ProbAttention forms at factors 1, 3 and 5
    over L_K 2 ... 4096, against eager ``jnp.linspace``: 12,278 pairs, among
    them (17, 15), where torch.linspace picks other keys. Under ``jax.jit``
    the sample is a compile-time constant, folded by XLA: held at (17, 15)
    and at the pairs where f32 i / (U - 1) x stop would truncate apart."""
    pairs = _sample_pairs()
    assert len(pairs) == 12278 and (17, 15) in pairs
    for L_K, U in pairs:
        want = np.asarray(jnp.linspace(0, L_K - 1, U).astype(jnp.int32))
        assert np.array_equal(att.prob_sample_index(L_K, U), want), (L_K, U)
    assert not np.array_equal(torch.linspace(0, 16, 15).to(torch.int32).numpy(),
                              att.prob_sample_index(17, 15))
    naive = [(L_K, U) for L_K, U in pairs[:3000] if U > 1 and not np.array_equal(
        np.append((np.float32(L_K - 1) * (np.arange(U - 1, dtype=np.float32)
                                          / np.float32(U - 1))).astype(np.int64), L_K - 1),
        att.prob_sample_index(L_K, U))]
    assert naive  # the naive f32 form differs somewhere: the check has teeth
    for L_K, U in [(17, 15)] + naive[:6]:
        want = jax.jit(lambda: jnp.linspace(0, L_K - 1, U).astype(jnp.int32))()
        assert np.array_equal(att.prob_sample_index(L_K, U), np.asarray(want)), (L_K, U)


# --------------------------------------------------------------------------
# Informer and the Non-stationary Transformer, whole
# --------------------------------------------------------------------------

class _JaxInformer(fnn.Module):
    """A 2-layer encoder, then a 1-layer Decoder (projection to ``c_out``)
    over ``x_dec``. ``kind`` "prob": Informer, ProbAttention with a
    ConvLayer between the encoder's layers and a FullAttention
    cross-attention; "ds": the Non-stationary Transformer, DSAttention
    everywhere and no ConvLayer, so ``delta`` [B, S_enc] reaches every
    encoder layer and the cross-attention."""
    d: int
    H: int
    kind: str
    c_out: int = 3

    def _inner(self, causal):
        if self.kind == "prob":
            return jatt.ProbAttention(mask_flag=causal, factor=5, attention_dropout=0.0)
        return jatt.DSAttention(mask_flag=causal, attention_dropout=0.0)

    @fnn.compact
    def __call__(self, x_enc, x_dec, tau=None, delta=None):
        d, H = self.d, self.H
        enc_layers = tuple(jtf.EncoderLayer(
            jatt.AttentionLayer(self._inner(False), d, H, name=f"enc_attn_{i}"), d, 2 * d,
            dropout=0.0, activation="gelu", name=f"enc_layer_{i}") for i in range(2))
        convs = (jtf.ConvLayer(d, name="conv_0"),) if self.kind == "prob" else None
        enc, _ = jtf.Encoder(enc_layers, convs, name="encoder")(x_enc, None, tau, delta)
        cross = (jatt.FullAttention(mask_flag=False, attention_dropout=0.0)
                 if self.kind == "prob" else self._inner(False))
        dec_layer = jtf.DecoderLayer(
            jatt.AttentionLayer(self._inner(True), d, H, name="dec_self"),
            jatt.AttentionLayer(cross, d, H, name="dec_cross"), d, 2 * d, dropout=0.0,
            activation="gelu", name="dec_layer_0")
        return jtf.Decoder((dec_layer,), projection_dim=self.c_out, name="decoder")(
            x_dec, enc, None, None, tau, delta)


class _Informer(torch.nn.Module):
    def __init__(self, d, H, kind, c_out=3):
        super().__init__()

        def inner(causal):
            if kind == "prob":
                return att.ProbAttention(mask_flag=causal, factor=5, p=0.0)
            return att.DSAttention(mask_flag=causal, p=0.0)

        layers = []
        for i in range(2):
            a = att.AttentionLayer(inner(False), d, H)
            setattr(self, f"enc_attn_{i}", a)
            layers.append(tf.EncoderLayer(a, d, 2 * d, p=0.0, activation_name="gelu"))
            setattr(self, f"enc_layer_{i}", layers[-1])
        convs = None
        if kind == "prob":
            self.conv_0 = tf.ConvLayer(d)
            convs = [self.conv_0]
        self.encoder = tf.Encoder(layers, d, conv_layers=convs)
        cross = att.FullAttention(mask_flag=False, p=0.0) if kind == "prob" else inner(False)
        self.dec_self = att.AttentionLayer(inner(True), d, H)
        self.dec_cross = att.AttentionLayer(cross, d, H)
        self.dec_layer_0 = tf.DecoderLayer(self.dec_self, self.dec_cross, d, 2 * d, p=0.0,
                                           activation_name="gelu")
        self.decoder = tf.Decoder([self.dec_layer_0], d, projection_dim=c_out)

    def forward(self, x_enc, x_dec, tau=None, delta=None):
        enc, _ = self.encoder(x_enc, tau=tau, delta=delta)
        return self.decoder(x_dec, enc, tau=tau, delta=delta)


def _informer(kind):
    """(JAX module, its variables (non-trivial running averages in the
    ConvLayer), its inputs, its output, the port on the same weights, the
    port's inputs). Encoder L 32 (16 after Informer's ConvLayer), decoder L
    24; ``tau`` [B] / ``delta`` [B, 32] for DS."""
    B, d, H = 2, 16, 4
    x_enc, x_dec = _x(10, B, 32, d), _x(11, B, 24, d)
    tau, delta = (np.abs(_x(12, B)) + 0.5, _x(13, B, 32)) if kind == "ds" else (None, None)
    jm = _JaxInformer(d, H, kind)
    jargs = [jnp.asarray(x_enc), jnp.asarray(x_dec)] + [
        None if a is None else jnp.asarray(a) for a in (tau, delta)]
    v = dict(_jit(lambda: jm.init(KEY, *jargs)))
    if kind == "prob":
        assert set(v["batch_stats"]["conv_0"]["norm"]) == {"mean", "var"}
        v["batch_stats"] = {"conv_0": {"norm": {
            "mean": jnp.asarray(_x(14, d)), "var": jnp.asarray(np.abs(_x(15, d)) + 0.2)}}}
    want = _jit(lambda: jm.apply(v, *jargs))
    tm = _load(_Informer(d, H, kind), v)
    targs = [_t(x_enc), _t(x_dec)] + [None if a is None else _t(a) for a in (tau, delta)]
    return jm, v, jargs, want, tm, targs


@pytest.fixture(scope="module")
def informer_prob():
    return _informer("prob")


@pytest.fixture(scope="module")
def informer_ds():
    return _informer("ds")


@pytest.mark.parametrize("kind", ["prob", "ds"])
def test_informer_encoder_decoder_matches_jax(kind, request):
    """The whole stack in eval; in train mode too (dropout 0, and the
    ConvLayer's BatchNorm keeps its running averages)."""
    _, _, _, want, tm, targs = request.getfixturevalue(f"informer_{kind}")
    _close(tm(*targs), want)
    _close(tm.train()(*targs), want)
    tm.eval()


def test_decoder_gradients_match_jax_grad(informer_ds):
    """d(sum(out * w)) / d(every parameter, x_enc, x_dec, tau, delta)
    against ``jax.grad`` of the same loss, on the Non-stationary form
    (DSAttention's tau and delta reach the scores of every attention)."""
    jm, v, jargs, want, tm, targs = informer_ds
    w = _x(16, *want.shape)

    def loss(params, *a):
        return jnp.sum(jm.apply({**v, "params": params}, *a) * w)

    jg = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(v["params"], *jargs)
    inputs = [t.detach().clone().requires_grad_(True) for t in targs]
    tm.zero_grad()
    (tm(*inputs) * _t(w)).sum().backward()
    _grads_close(tm, jg[0], inputs, jg[1:])


# --------------------------------------------------------------------------
# ConvLayer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("L", [16, 15])
def test_conv_layer_running_averages(L):
    """Random running averages and BatchNorm parameters, an odd and an even
    length: eval and train equal JAX's (which has no train mode here)."""
    B, d = 2, 8
    x = _x(L, B, L, d)
    jm = jtf.ConvLayer(d)
    v = dict(_jit(lambda: jm.init(KEY, jnp.asarray(x))))
    v["params"] = {**v["params"], "norm": {"scale": jnp.asarray(_x(1, d)),
                                           "bias": jnp.asarray(_x(2, d))}}
    v["batch_stats"] = {"norm": {"mean": jnp.asarray(_x(3, d)),
                                 "var": jnp.asarray(np.abs(_x(4, d)) + 0.1)}}
    want = _jit(lambda: jm.apply(v, jnp.asarray(x)))
    tm = _load(tf.ConvLayer(d), v)
    assert want.shape == (B, (L - 1) // 2 + 1, d)
    _close(tm(_t(x)), want)
    _close(tm.train()(_t(x)), want)


# --------------------------------------------------------------------------
# ReformerLayer and the LSH attention
# --------------------------------------------------------------------------

def _jax_rotations(bucket_size, n_hashes, path, dh, L):
    """The rotations JAX's ReformerLayer draws (ops/attention.py:212-215,
    ops/lsh_attention.py:69): [n_hashes, dh, nb / 2]."""
    salt = zlib.crc32(path.encode())
    rng = jax.random.PRNGKey((bucket_size * 7919 + n_hashes + salt) % (2 ** 31))
    nb = max(2, 2 * (L // (2 * bucket_size)))
    return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(rng, r), (dh, nb // 2),
                                                  jnp.float32)) for r in range(n_hashes)])


@pytest.fixture(scope="module", params=[32, 30])
def reformer(request):
    """N 32 (a multiple of 2 x bucket_size) and 30 (padded to 32): the JAX
    layer at the root (path ""), its variables and output, the port with
    JAX's rotations."""
    N, d, H, bs, nh = request.param, 32, 4, 4, 2
    x = _x(N, 2, N, d)
    jm = jatt.ReformerLayer(d_model=d, n_heads=H, bucket_size=bs, n_hashes=nh)
    v = _jit(lambda: jm.init(KEY, jnp.asarray(x)))
    want = _jit(lambda: jm.apply(v, jnp.asarray(x))[0])
    tm = _load(att.ReformerLayer(d, H, bucket_size=bs, n_hashes=nh), v)
    rot = _jax_rotations(bs, nh, "", d // H, tm.padded_length(N))
    return x, jm, v, want, tm, rot


def test_reformer_buckets_and_output_match_jax(reformer):
    x, jm, v, want, tm, rot = reformer
    B, N, _ = x.shape
    L = tm.padded_length(N)
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, L - N), (0, 0)))
    qk = (xp @ v["params"]["qk_projection"]["kernel"]).reshape(B, L, 4, -1).transpose(0, 2, 1, 3)
    jb = np.stack([np.asarray(jlsh._bucket(qk, jnp.asarray(r))) for r in rot])
    got_b = tm.buckets(_t(x), _t(rot))
    assert got_b.shape == jb.shape and np.array_equal(got_b.numpy(), jb)
    _close(tm(_t(x), rotations=_t(rot))[0], want)
    _close(tm(_t(x), rotations=_t(rot), buckets=got_b)[0], want)
    # its own draws: seeded from JAX's key formula, the same on every call,
    # other numbers than JAX's
    own = tm.rotations(N, torch.device("cpu"))
    assert own.shape == rot.shape and torch.equal(own, tm.rotations(N, torch.device("cpu")))
    assert not np.allclose(own.numpy(), rot)
    torch.testing.assert_close(tm(_t(x))[0], tm(_t(x), rotations=own)[0], rtol=0, atol=0)


def test_reformer_gradients_match_jax_grad(reformer):
    x, jm, v, want, tm, rot = reformer
    w = _x(5, *want.shape)
    jg = jax.jit(jax.grad(lambda p, a: jnp.sum(jm.apply({"params": p}, a)[0] * w),
                          argnums=(0, 1)))(v["params"], jnp.asarray(x))
    xt = _t(x, grad=True)
    tm.zero_grad()
    (tm(xt, rotations=_t(rot))[0] * _t(w)).sum().backward()
    _grads_close(tm, jg[0], [xt], jg[1:])


def _full_attention_shared_qk(qk, v, causal=False):
    """Full softmax attention with Reformer's normalized keys and its
    self-mask (-5e4 on the diagonal), in numpy."""
    N, dh = qk.shape[2], qk.shape[-1]
    k = qk / np.maximum(np.linalg.norm(qk, axis=-1, keepdims=True), 1e-6)
    s = np.einsum("bhqd,bhkd->bhqk", qk, k) / np.sqrt(dh)
    s = np.where(np.eye(N, dtype=bool), -5e4, s)
    if causal:
        s = np.where(np.tril(np.ones((N, N), bool)), s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)


def _rot(seed, n_hashes, dh, N, bucket_size):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n_hashes, dh, lsh.n_buckets(N, bucket_size) // 2, generator=g)


def test_lsh_single_chunk_equals_full_attention():
    """N == 2 x bucket_size: one chunk, every token attends every other."""
    qk, v = _x(0, 2, 2, 8, 16), _x(1, 2, 2, 8, 16)
    out = lsh.lsh_attention(_t(qk), _t(v), _rot(0, 2, 16, 8, 4), bucket_size=4)
    np.testing.assert_allclose(out.numpy(), _full_attention_shared_qk(qk, v), rtol=2e-3,
                               atol=2e-3)
    with pytest.raises(ValueError, match="multiple"):
        lsh.lsh_attention(_t(qk[:, :, :6]), _t(v[:, :, :6]), _rot(0, 2, 16, 8, 4))


def test_lsh_causal_no_future_leakage():
    """A future token's value never reaches an earlier output."""
    qk, v = _x(1, 1, 2, 32, 8), _x(2, 1, 2, 32, 8)
    rot = _rot(1, 4, 8, 32, 4)
    out1 = lsh.lsh_attention(_t(qk), _t(v), rot, causal=True)
    v2 = v.copy()
    v2[:, :, -1] -= 10.0
    out2 = lsh.lsh_attention(_t(qk), _t(v2), rot, causal=True)
    np.testing.assert_allclose(out1[:, :, :-1].numpy(), out2[:, :, :-1].numpy(), rtol=1e-5,
                               atol=1e-5)


def test_lsh_value_propagates_to_bucket_mates():
    qk, v = _x(6, 1, 2, 32, 8), _x(7, 1, 2, 32, 8)
    rot = _rot(2, 4, 8, 32, 4)
    v2 = v.copy()
    v2[:, :, 7] += 10.0
    out1 = lsh.lsh_attention(_t(qk), _t(v), rot)
    out2 = lsh.lsh_attention(_t(qk), _t(v2), rot)
    assert (out1 - out2).abs().max().item() > 1e-3


def test_lsh_approximates_full_attention_on_clustered_inputs():
    """Two well-separated clusters: the hashes follow them, and the bucketed
    attention's rows point where full attention's do (cosine > 0.9)."""
    rng = np.random.default_rng(2)
    N, dh = 64, 16
    centers = rng.normal(size=(2, dh)).astype(np.float32) * 4
    qk = (centers[rng.integers(0, 2, N)]
          + 0.1 * rng.normal(size=(N, dh)).astype(np.float32))[None, None]
    v = rng.normal(size=(1, 1, N, dh)).astype(np.float32)
    out = lsh.lsh_attention(_t(qk), _t(v), _rot(3, 8, dh, N, 8), bucket_size=8).numpy()
    ref = _full_attention_shared_qk(qk, v)
    cos = (out * ref).sum(-1) / np.maximum(np.linalg.norm(out, axis=-1)
                                           * np.linalg.norm(ref, axis=-1), 1e-6)
    assert cos.mean() > 0.9


# --------------------------------------------------------------------------
# Crossformer, TimesNet's V2 block, the head, RevIN's affine, the DFT
# --------------------------------------------------------------------------

def test_two_stage_attention_layer():
    """3 variables x 4 segments (seg_num 4), router of 3 tokens."""
    x = _x(20, 2, 3, 4, 16)
    jm = jcf.TwoStageAttentionLayer(seg_num=4, factor=3, d_model=16, n_heads=4, d_ff=32,
                                    dropout=0.0, attention_dropout=0.0)
    v = _jit(lambda: jm.init(KEY, jnp.asarray(x)))
    tm = _load(cf.TwoStageAttentionLayer(4, 3, 16, 4, 32, p=0.0, attention_p=0.0), v)
    assert tuple(tm.router.shape) == (4, 3, 16)
    _close(tm(_t(x)), _jit(lambda: jm.apply(v, jnp.asarray(x))))


def test_inception_block_v2():
    """Separable kernels 3 and 5 and the 1 x 1 at a period that does not
    divide T; the kernels keep the flax layouts and names."""
    T, Nin, Nout = 30, 4, 6
    x = np.concatenate([_x(21, 2, T, Nin), np.zeros((2, T, Nin), np.float32)], 1)
    jm = jinc.InceptionBlockV2(Nout, num_kernels=4)
    args = (jnp.asarray(x), jnp.asarray(7))
    v = _jit(lambda: jm.init(KEY, *args, seq_len=T, out_len=2 * T))
    tm = _load(inc.InceptionBlockV2(Nin, Nout, 4), v)
    assert tuple(tm.row_kernel_1.shape) == (1, 5, Nin, Nout)
    assert tuple(tm.col_kernel_1.shape) == (5, 1, Nin, Nout)
    _close(tm(_t(x), torch.tensor(7), seq_len=T, out_len=2 * T),
           _jit(lambda: jm.apply(v, *args, seq_len=T, out_len=2 * T)))


def test_flatten_head():
    x = _x(22, 2, 3, 4, 8)
    jm = jheads.FlattenHead(target_window=5)
    v = _jit(lambda: jm.init(KEY, jnp.asarray(x)))
    _close(_load(heads.FlattenHead(32, 5), v)(_t(x)), _jit(lambda: jm.apply(v, jnp.asarray(x))))


def test_revin_affine():
    x = _x(23, 2, 10, 3)
    jm = jrevin.RevINAffine(3)
    v = {"params": {"affine_weight": jnp.asarray(_x(1, 3)),
                    "affine_bias": jnp.asarray(_x(2, 3))}}
    tm = _load(revin.RevINAffine(3), v)
    for mode in ("norm", "denorm"):
        _close(tm(_t(x), mode), _jit(lambda: jm.apply(v, jnp.asarray(x), mode)))
    with pytest.raises(NotImplementedError):
        tm(_t(x), "other")


@pytest.mark.parametrize("L,n", [(32, None), (33, 40), (40, 33), (2050, None)])
def test_complex_rfft_irfft(L, n):
    """The basis forms and, past 2048 steps, the FFT's; zero-padded and cut."""
    x = _x(L, 3, L)
    got = dft.rfft(_t(x), n)
    want = jdft.rfft(jnp.asarray(x), n)
    assert got.dtype == torch.complex64
    _close(got.real, np.real(want))
    _close(got.imag, np.imag(want))
    m = n or L
    _close(dft.irfft(got, m), jdft.irfft(want, m))
    _close(dft.irfft(got[..., :5], m + 1), jdft.irfft(want[..., :5], m + 1))


# --------------------------------------------------------------------------
# the package surface and the init
# --------------------------------------------------------------------------

def test_ops_exports_the_jax_packages_names():
    want = {n for n, obj in vars(jops).items()
            if not n.startswith("_") and not isinstance(obj, type(jops)) and n != "annotations"}
    assert set(ops.__all__) == want
    for name in ops.__all__:
        assert getattr(ops, name).__name__ == name


def test_init_random_draws_jax_distributions():
    """The router N(0, 1); V2's kernels N(0, 2 / fan_out), fan_out = K_rows x
    K_cols x Nout; the circular conv lecun-normal, its bias 0; the
    BatchNorm 1 / 0 with running averages 0 / 1; RevIN's affine 1 / 0."""
    g = torch.Generator().manual_seed(0)
    tsa = cf.TwoStageAttentionLayer(16, 10, 64, 4)
    block = inc.InceptionBlockV2(32, 64, 6)
    conv = tf.ConvLayer(64)
    aff = revin.RevINAffine(8)
    for m in (tsa, block, conv, aff):
        for t in (*m.parameters(), *m.buffers()):
            t.data.fill_(7.0)
        init_random_(m, g)
    assert abs(tsa.router.std().item() - 1.0) < 0.05 and abs(tsa.router.mean().item()) < 0.05
    for name, w in block.named_parameters():
        if "kernel" in name:
            std = math.sqrt(2.0 / (w.shape[0] * w.shape[1] * w.shape[3]))
            assert abs(w.std().item() / std - 1) < 0.1, name
        else:
            assert not w.any(), name
    std = 1.0 / math.sqrt(64 * 3)
    assert abs(conv.downConv.weight.std().item() / std - 1) < 0.1
    assert conv.downConv.weight.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    assert not conv.downConv.bias.any()
    assert (conv.norm.scale == 1).all() and not conv.norm.bias.any()
    assert not conv.norm.mean.any() and (conv.norm.var == 1).all()
    assert (aff.affine_weight == 1).all() and not aff.affine_bias.any()
