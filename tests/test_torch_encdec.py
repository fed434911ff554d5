"""The encoder-decoder backbones (t5 / mt5, bart, the llama-style
``encdec-tiny`` and the gpt2 style) in the port against the JAX package on
the CPU, at the tiny presets.

  (a) ``t5_relative_buckets`` bit-equal to JAX's, both directions, past
      ``max_distance``;
  (b) ``TransformerEncDec`` on ``from_flax`` weights: dense f32 within
      1e-5 for every style (t5 relu and gated, bart, llama, gpt2 through
      ``dataclasses.replace``), bart's ``scale_embedding`` on the ids path;
      w8a8, absmax int4 and the nf4 codebook within the flip-sized bound
      of ROADMAP queue 3 (2e-3 of the output's largest);
  (c) remat ("full", "dots") bit-equal to no remat: the output, the input's
      gradient and every parameter's, on t5 with LoRA and bart with dropout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtsllm_tpu.models.llm import transformer as jtf
from medtsllm_tpu.models.llm.loader import PRESETS as JAX_PRESETS
from medtsllm_tpu_torch.models.llm import transformer as ttf
from medtsllm_tpu_torch.models.llm.config import PRESETS, LoraSpec
from medtsllm_tpu_torch.weights import from_flax, init_random_

torch.set_num_threads(1)


def _cfgs(name):
    """(JAX config, port config): the presets, "t5-gated" (t5-tiny's gated
    FFN), "bart-scaled" (bart-tiny with scale_embedding) and "gpt2-encdec"
    (gpt2-tiny as an encoder-decoder, dropout 0)."""
    extra = {"t5-gated": ("t5-tiny", dict(t5_gated=True)),
             "bart-scaled": ("bart-tiny", dict(scale_embedding=True)),
             "gpt2-encdec": ("gpt2-tiny", dict(is_encoder_decoder=True, dropout=0.0))}
    base, fields = extra.get(name, (name, {}))
    return (dataclasses.replace(JAX_PRESETS[base], **fields),
            dataclasses.replace(PRESETS[base], **fields))


# --------------------------------------------------------------------------
# (a) the buckets
# --------------------------------------------------------------------------

@pytest.mark.parametrize("buckets,max_distance", [(32, 128), (8, 20)])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_buckets_bit_equal(bidirectional, buckets, max_distance):
    """L 300 x S 300: distances past max_distance reach the last bucket."""
    kw = dict(bidirectional=bidirectional, num_buckets=buckets, max_distance=max_distance)
    want = np.asarray(jtf.t5_relative_buckets(300, 300, **kw))
    got = ttf.t5_relative_buckets(300, 300, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() == buckets - 1


# --------------------------------------------------------------------------
# (b) the backbone
# --------------------------------------------------------------------------

def _params(module, e, d, seed=0):
    """flax init with each quantized projection's per-channel scale drawn
    at random (the init's constant scale would hide a channel-order bug)."""
    params = jax.jit(lambda k, e, d: module.init(k, inputs_embeds=e, decoder_inputs_embeds=d)
                     )(jax.random.PRNGKey(seed), e, d)["params"]
    rng = np.random.default_rng(seed)

    def fix(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fix(v)
            elif k == "scale" and "kernel_q" in tree:
                out[k] = jnp.asarray(rng.uniform(2e-4, 1e-3, v.shape), jnp.float32)
            else:
                out[k] = v
        return out
    return fix(jax.device_get(params))


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(0, 0.5, shape).astype(np.float32)


_MODULES = [("encdec-tiny", 0, "absmax"), ("t5-tiny", 0, "absmax"), ("t5-gated", 0, "absmax"),
            ("bart-tiny", 0, "absmax"), ("gpt2-encdec", 0, "absmax"),
            ("t5-tiny", 8, "absmax"), ("bart-tiny", 8, "absmax"), ("encdec-tiny", 8, "absmax"),
            ("bart-tiny", 4, "absmax"), ("t5-gated", 4, "nf4")]


@pytest.mark.parametrize("name,quantize,codebook", _MODULES,
                         ids=[f"{n}-q{q}-{c}" for n, q, c in _MODULES])
def test_encdec_matches_jax(name, quantize, codebook):
    jc, tc = _cfgs(name)
    jc = dataclasses.replace(jc, quant4_codebook=codebook)
    tc = dataclasses.replace(tc, quant4_codebook=codebook)
    e, d = jnp.asarray(_x(1, 2, 12, 64)), jnp.asarray(_x(2, 2, 7, 64))
    jm = jtf.TransformerEncDec(jc, quantize=quantize)
    p = _params(jm, e, d)
    want = np.asarray(jax.jit(lambda p, e, d: jm.apply(
        {"params": p}, inputs_embeds=e, decoder_inputs_embeds=d))(p, e, d))
    tm = ttf.TransformerEncDec(tc, quantize).eval()
    state = from_flax(p)
    assert set(state) == set(tm.state_dict())
    tm.load_state_dict(state)
    with torch.no_grad():
        got = tm(torch.from_numpy(np.asarray(e)), torch.from_numpy(np.asarray(d))).numpy()
    tol = 1e-5 if quantize == 0 or codebook != "absmax" else 2e-3
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


def test_bart_scaled_embedding_ids_path():
    """HF's BartScaledWordEmbedding: ``embed`` (the ids path) scales by
    sqrt(d_model); inputs_embeds pass unscaled."""
    jc, tc = _cfgs("bart-scaled")
    e, d = jnp.asarray(_x(3, 1, 8, 64)), jnp.asarray(_x(4, 1, 5, 64))
    jm = jtf.TransformerEncDec(jc)
    p = _params(jm, e, d)
    tm = ttf.TransformerEncDec(tc).eval()
    tm.load_state_dict(from_flax(p))
    ids = np.array([[1, 5, 9, 20, 33, 2, 7, 11]])
    emb_j = jax.jit(lambda p, i: jm.apply({"params": p}, i, method="embed"))(
        p, jnp.asarray(ids))
    emb_t = tm.embed(torch.from_numpy(ids))
    np.testing.assert_array_equal(emb_t.numpy(), np.asarray(emb_j))
    np.testing.assert_allclose(emb_t.numpy(), tm.wte[ids].numpy() * 8.0, rtol=1e-6)
    want = jax.jit(lambda p, e, d: jm.apply({"params": p}, inputs_embeds=e,
                                            decoder_inputs_embeds=d))(p, emb_j, d)
    with torch.no_grad():
        got = tm(emb_t, torch.from_numpy(np.asarray(d)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# (c) remat
# --------------------------------------------------------------------------

def _module(name, remat):
    _, tc = _cfgs(name)
    lora = LoraSpec(rank=4, alpha=8, targets=("q", "v")) if name == "t5-tiny" else None
    if name == "bart-tiny":
        tc = dataclasses.replace(tc, dropout=0.1)
    m = ttf.TransformerEncDec(tc, 8 if name == "t5-tiny" else 0, None, lora, True, remat)
    init_random_(m, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for n, p in m.named_parameters():
            if "lora_b" in n:
                p.normal_(0, 0.1, generator=torch.Generator().manual_seed(1))
    for n, p in m.named_parameters():
        p.requires_grad_("wte" not in n)
    return m.train()


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("name", ["t5-tiny", "bart-tiny"])
def test_remat_is_bit_equal(name, remat):
    """Every block recomputed (twice as many block calls), the dropout
    masks drawn once; the output, both inputs' gradients and every
    parameter's gradient bit-equal."""
    m0, m1 = _module(name, False), _module(name, remat)
    e = torch.from_numpy(_x(5, 2, 10, 64))
    d = torch.from_numpy(_x(6, 2, 6, 64))

    def run(m):
        calls = []
        hooks = [b.register_forward_pre_hook(lambda *_: calls.append(1))
                 for b in list(m.enc_blocks) + list(m.dec_blocks)]
        gen = torch.Generator().manual_seed(3)
        et, dt = e.clone().requires_grad_(), d.clone().requires_grad_()
        y = m(et, dt, generator=gen)
        (y.square().mean() + y.mean()).backward()
        for h in hooks:
            h.remove()
        grads = {n: p.grad.clone() for n, p in m.named_parameters() if p.grad is not None}
        return y.detach(), et.grad, dt.grad, grads, len(calls), gen.get_state()

    y0, de0, dd0, g0, c0, s0 = run(m0)
    y1, de1, dd1, g1, c1, s1 = run(m1)
    assert torch.equal(y0, y1) and torch.equal(de0, de1) and torch.equal(dd0, dd1)
    assert g0.keys() == g1.keys() and len(g0) > 1
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    n_blocks = len(m0.enc_blocks) + len(m0.dec_blocks)
    assert c0 == n_blocks and c1 == 2 * n_blocks
    assert torch.equal(s0, s1)
