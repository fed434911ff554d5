"""Training through the quantized projections, the port against the JAX
package on the CPU.

  (a) the int8 dx of ``llm.int8_backward`` (``_act_quant_matmul`` under
      ``jax.vjp`` with ``int8_bwd``) bit-equal at 8 and 4 bits (odd K too),
      and the batched dh of the capacity MoE path (``_act_quant_bmm``) at 8
      bits and on unpacked 4-bit experts; the straight-through dx beside
      them within 1e-5 x max; the gradient rows' quantizer against its law
      (the scale folded in f32, per-expert scale rows, zero padding
      columns, a bf16 gradient taken exactly); the int8 dx's cosine with the
      straight-through dx above 0.999 (JAX's
      ``test_int8_backward_tracks_ste_gradient``);
  (b) ``MedTsLLM._resolve_act_quant``'s modes and ValueErrors, case by
      case; the weight-only product (``int8_matmul = false``) and the nf4 /
      fp4 codebooks against ``QuantDense`` forward and backward (1e-5);
  (c) the zero-column padding of the GEMMs' contraction widths (the weight
      padded once, the codes per call) giving the same bits forward and
      backward; the ``[K, N]`` copy refilled in place by
      ``load_state_dict`` and kept out of the state dict;
  (d) three SGD steps of the llama-tiny w8a8 finetune with
      ``int8_backward`` against JAX's ``train_step`` (the w8a8 bounds of
      tests/test_torch_train.py), and QLoRA (``load_in_4bit`` absmax int4,
      LoRA) through ``train()`` against JAX's trainer's ``train()``: the
      losses and every trainable tensor at the same flip-sized bounds, the
      backbone unmoved.
"""

import contextlib
import warnings

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_config
from medtsllm_tpu.models.llm import transformer as jtf
from medtsllm_tpu.models.medtsllm import MedTsLLM as JaxMedTsLLM
from medtsllm_tpu.ops.pallas import quant_matmul as jqm
from test_torch_baseline_tasks import jax_get_trainer_jitted as jax_get_trainer
from medtsllm_tpu_torch.config import Config
from medtsllm_tpu_torch.models.llm import transformer as ttf
from medtsllm_tpu_torch.models.medtsllm import resolve_act_quant
from medtsllm_tpu_torch.ops.kernels import w4a8 as k5
from medtsllm_tpu_torch.ops.kernels import w8a8 as k1
from medtsllm_tpu_torch.tasks import get_trainer
from medtsllm_tpu_torch.weights import from_flax

torch.set_num_threads(1)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


def _linear(kq, scale, K, N, bits, act_quant, codebook="absmax"):
    """A port QuantLinear holding JAX's kernel_q [K or K/2, N] and scale."""
    lin = ttf.QuantLinear(K, N, None, bits, codebook, act_quant=act_quant)
    lin.load_state_dict({"weight_q": torch.from_numpy(np.ascontiguousarray(np.asarray(kq).T)),
                         "scale": torch.from_numpy(np.asarray(scale))})
    return lin


def _case(seed, bits, M, K, N):
    rs = np.random.RandomState(seed)
    x = rs.randn(M, K).astype(np.float32)
    g = rs.randn(M, N).astype(np.float32)
    q = rs.randint(-127, 128, (K, N)) if bits == 8 else rs.randint(-7, 8, (K, N))
    q = q.astype(np.int8)
    kq = q if bits == 8 else np.asarray(jqm.pack4_split(q))
    scale = (rs.rand(N) * 1e-2 + 1e-3).astype(np.float32)
    return x, g, kq, scale


# --------------------------------------------------------------------------
# (a) the int8 dx and dh
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bits,K", [(8, 40), (8, 64), (4, 40), (4, 39)])
def test_int8_dx_matches_jax(bits, K):
    M, N = 6, 24
    x, g, kq, scale = _case(K + bits, bits, M, K, N)
    for int8_bwd in (False, True):
        y, vjp = jax.vjp(lambda xx: jtf._act_quant_matmul(
            xx, jnp.asarray(kq), jnp.asarray(scale), bits, int8_bwd), jnp.asarray(x))
        (want,) = vjp(jnp.asarray(g))
        lin = _linear(kq, scale, K, N, bits, "int8_bwd" if int8_bwd else True)
        xt = torch.from_numpy(x).requires_grad_()
        out = lin(xt)
        out.backward(torch.from_numpy(g))
        np.testing.assert_array_equal(_np(out), _np(y))
        if int8_bwd:
            np.testing.assert_array_equal(_np(xt.grad), _np(want))
            assert lin.kn_copy.shape == (K, N + (-N % 16))
        else:  # the straight-through dx: a float matmul, summed in another order
            np.testing.assert_allclose(_np(xt.grad), _np(want), rtol=0,
                                       atol=1e-5 * np.abs(_np(want)).max())
            assert "kn_copy" not in dict(lin.named_buffers())


@pytest.mark.parametrize("bits", [8, 4])
def test_int8_dh_matches_jax(bits):
    """The capacity path's per-expert dh; at 4 bits JAX unpacks the experts
    before ``_act_quant_bmm``, as ``MoEMLP._bmm`` / ``_kn`` do."""
    rs = np.random.RandomState(bits)
    E, C, K, N = 3, 5, 40, 24
    h = rs.randn(E, C, K).astype(np.float32)
    g = rs.randn(E, C, N).astype(np.float32)
    q = rs.randint(-127, 128, (E, K, N)) if bits == 8 else rs.randint(-7, 8, (E, K, N))
    q = q.astype(np.int8)
    scale = (rs.rand(E, N) * 1e-2 + 1e-3).astype(np.float32)
    wq = torch.from_numpy(np.ascontiguousarray(q.transpose(0, 2, 1)))
    if bits == 4:  # the experts as the port stores them, unpacked by _kn
        moe = ttf.MoEMLP.__new__(ttf.MoEMLP)
        torch.nn.Module.__init__(moe)
        moe.quantize = 4
        moe.w_up_q = k5.pack4_split(wq)
        assert torch.equal(moe._kn("w_up", K), k1.kn_weight(wq))
    for int8_bwd in (False, True):
        y, vjp = jax.vjp(lambda hh: jtf._act_quant_bmm(
            hh, jnp.asarray(q), jnp.asarray(scale), int8_bwd), jnp.asarray(h))
        (want,) = vjp(jnp.asarray(g))
        ht = torch.from_numpy(h).requires_grad_()
        out = ttf.act_quant_bmm(ht, wq, torch.from_numpy(scale),
                                (lambda: k1.kn_weight(wq)) if int8_bwd else None)
        out.backward(torch.from_numpy(g))
        np.testing.assert_array_equal(_np(out), _np(y))
        if int8_bwd:
            np.testing.assert_array_equal(_np(ht.grad), _np(want))
        else:
            np.testing.assert_allclose(_np(ht.grad), _np(want), rtol=0,
                                       atol=1e-5 * np.abs(_np(want)).max())


def test_grad_row_quantizer_law():
    rs = np.random.RandomState(3)
    M, N, E = 8, 20, 4
    g = torch.from_numpy(rs.randn(M, N).astype(np.float32))
    g[2] = 0.0  # an all-zero row: the 1e-10 floor
    scale = torch.from_numpy((rs.rand(E, N) * 1e-2).astype(np.float32))
    gq, g_scale = k1.quantize_grad_rows(g, scale, ld=32)
    gs = (g.numpy().reshape(E, M // E, N) * scale.numpy()[:, None]).reshape(M, N)
    want_s = np.maximum(np.abs(gs).max(-1) / np.float32(127.0), np.float32(1e-10))
    np.testing.assert_array_equal(g_scale.numpy(), want_s)
    np.testing.assert_array_equal(gq.numpy()[:, :N], np.round(gs / want_s[:, None]))
    assert gq.shape == (M, 32) and not gq[:, N:].any()
    # one scale row for every row; a bf16 gradient is taken exactly
    gb = g.to(torch.bfloat16)
    a = k1.quantize_grad_rows(gb, scale[0])
    b = k1.quantize_grad_rows(gb.float(), scale[0])
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    with pytest.raises(ValueError, match="dividing M"):
        k1.quantize_grad_rows(g, scale[:3])


def test_int8_dx_tracks_ste():
    """cos(int8 dx, straight-through dx) > 0.999 through a projection and
    the expert bmm (JAX's test_quantization.py::
    test_int8_backward_tracks_ste_gradient)."""
    x, _, kq, scale = _case(7, 8, 8, 64, 32)

    def cos(a, b):
        a, b = _np(a).ravel(), _np(b).ravel()
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    grads = []
    for mode in (True, "int8_bwd"):
        xt = torch.from_numpy(x).requires_grad_()
        (_linear(kq, scale, 64, 32, 8, mode)(xt) ** 2).sum().backward()
        grads.append(xt.grad)
    assert cos(*grads) > 0.999
    wq = torch.from_numpy(np.ascontiguousarray(
        np.random.RandomState(1).randint(-127, 128, (2, 32, 64)).astype(np.int8)))
    sc = torch.full((2, 32), 1e-2)
    h = torch.from_numpy(x.reshape(2, 4, 64))
    grads = []
    for w_kn in (None, lambda: k1.kn_weight(wq)):
        ht = h.clone().requires_grad_()
        (ttf.act_quant_bmm(ht, wq, sc, w_kn) ** 2).sum().backward()
        grads.append(ht.grad)
    assert cos(*grads) > 0.999


# --------------------------------------------------------------------------
# (b) the act-quant modes, weight-only and the codebooks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("llm", [
    {},
    {"int8_matmul": False},
    {"int8_backward": True},
    {"int8_backward": True, "int8_matmul": False},
    {"int8_backward": True, "quantize": 4},
    {"int8_backward": True, "quantize": 4, "codebook": "nf4"},
    {"int8_backward": True, "quantize": 0},
])
def test_resolve_act_quant_matches_jax(llm):
    llm = dict(llm)
    quantize, codebook = llm.pop("quantize", 8), llm.pop("codebook", "absmax")
    cfg = Config({"llm": llm})

    class JaxCfg:
        quant4_codebook = codebook
    try:
        want = JaxMedTsLLM._resolve_act_quant(cfg, quantize, JaxCfg)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            resolve_act_quant(cfg.llm, quantize, codebook)
        assert str(got.value) == str(e)
        return
    assert resolve_act_quant(cfg.llm, quantize, codebook) == want


@pytest.mark.parametrize("bits,codebook,K", [(8, "absmax", 40), (4, "absmax", 40),
                                             (4, "absmax", 39), (4, "nf4", 40),
                                             (4, "fp4", 40)])
def test_weight_only_and_codebooks_match_quantdense(bits, codebook, K):
    """``int8_matmul = false`` (act_quant False) and the bnb codebooks:
    ``(x @ W) * scale`` at the compute dtype, differentiated as a plain
    matmul, against ``QuantDense`` and ``jax.grad`` within 1e-5."""
    N = 24
    act_quant = codebook != "absmax"  # the codebooks ignore it, as in JAX
    jm = jtf.QuantDense(N, use_bias=False, bits=bits, act_quant=act_quant, codebook=codebook)
    x = np.random.RandomState(K).randn(2, 5, K).astype(np.float32)
    p = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    p["scale"] = (np.random.RandomState(1).rand(N) * 1e-2 + 1e-3).astype(np.float32)
    c = np.random.RandomState(2).randn(2, 5, N).astype(np.float32)
    y, want = jax.jit(jax.value_and_grad(lambda xx: jnp.sum(jm.apply({"params": p}, xx) * c)))(
        jnp.asarray(x))
    lin = ttf.QuantLinear(K, N, None, bits, codebook, act_quant=act_quant)
    lin.load_state_dict(from_flax(p))
    xt = torch.from_numpy(x).requires_grad_()
    got = (lin(xt) * torch.from_numpy(c)).sum()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(y), rtol=1e-5)
    np.testing.assert_allclose(_np(xt.grad), _np(want), rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# (c) padded widths and the derived copies
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bits,K", [(8, 40), (4, 40), (4, 50)])
def test_padded_weights_give_the_same_bits(bits, K):
    """The card's route for a contraction width off the GEMMs' 16-byte rows
    (K % 16, or K / 2 % 16 at 4 bits): the weight padded with zero columns,
    the codes padded per call; the same bits forward, through the
    straight-through dx and through the int8 dx."""
    x, g, kq, scale = _case(K, bits, 5, K, 24)
    wq_t = torch.from_numpy(np.ascontiguousarray(kq.T))
    sc = torch.from_numpy(scale)
    if bits == 8:
        run = k1.act_quant_matmul
        padded = k1.pad_cols(wq_t)
        w8 = wq_t
    else:
        run = k5.act_quant_w4a8_matmul
        padded = k5.pad_packed(wq_t, K)
        w8 = k5.unpack4_split(wq_t, K)
        assert padded.shape[1] % 16 == 0
        assert torch.equal(k5.unpack4_split(padded, 2 * padded.shape[1])[:, :K], w8)
    for w_kn in (None, lambda: k1.kn_weight(w8)):
        outs = []
        for w in (wq_t, padded):
            xt = torch.from_numpy(x).requires_grad_()
            y = run(xt, w, sc, torch.float32, w_kn)
            y.backward(torch.from_numpy(g))
            outs.append((y.detach(), xt.grad))
        assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_derived_copy_follows_load_state_dict():
    x, g, kq, scale = _case(0, 8, 4, 32, 16)
    lin = _linear(kq, scale, 32, 16, 8, "int8_bwd")
    xt = torch.from_numpy(x).requires_grad_()
    lin(xt).backward(torch.from_numpy(g))
    kn = lin.kn_copy
    assert "kn_copy" not in lin.state_dict()
    kq2 = np.random.RandomState(9).randint(-127, 128, kq.shape).astype(np.int8)
    lin.load_state_dict({"weight_q": torch.from_numpy(np.ascontiguousarray(kq2.T)),
                         "scale": torch.from_numpy(scale)})
    assert lin.kn_copy is kn  # refilled where it lies
    assert torch.equal(kn[:, :16], torch.from_numpy(kq2))


# --------------------------------------------------------------------------
# (d) MedTsLLM through the trainers
# --------------------------------------------------------------------------

@contextlib.contextmanager
def jitted_flax_init():
    """flax ``Module.init`` under ``jax.jit`` while a JAX trainer is built."""
    eager = nn.Module.init

    def init(self, rngs, *args, **kwargs):
        return jax.jit(lambda r, a: eager(self, r, *a, **kwargs))(rngs, args)
    nn.Module.init = init
    try:
        yield
    finally:
        nn.Module.init = eager


def _cfg(tmp_path, llm_kw, lora=False):
    cfg = make_config(task="reconstruction", model="medtsllm", hist=32, pred=32, step=16)
    cfg["paths"] = {"logdir": str(tmp_path / "logs")}
    cfg.training.batch_size = 4
    cfg.training.epochs = 1
    cfg.training.optimizer = "sgd"
    cfg.training.learning_rate = 1e-2
    cfg.datasets.synthetic.n_points = 120
    cfg["models"] = {"medtsllm": {
        "d_model": 16, "d_ff": 16, "n_heads": 4, "num_tokens": 32,
        "covariate_mode": "concat", "embedding_downsample_mode": "linear",
        "patching": {"patch_len": 8, "stride": 4},
        "prompting": {"dataset": True, "task": True, "clip": False,
                      "input_stats": True, "examples": False,
                      "input_stats_dim": 0, "input_stats_select": "all",
                      "cache_order": True},
        "llm": dict({"enabled": True, "llm": "llama-tiny", "llm_layers": -1,
                     "prefix_cache": True, "load_in_4bit": False, "load_in_8bit": True},
                    **llm_kw)}}
    if lora:
        cfg["models"]["medtsllm"]["lora"] = {"enabled": True, "rank": 4, "alpha": 8,
                                             "layers": "auto"}
    return cfg


def _pair(cfg):
    with jitted_flax_init(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt = jax_get_trainer("jax", cfg)
        tt = get_trainer("port", cfg, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    return jt, tt


def test_int8_backward_train_steps_match_jax(tmp_path):
    """The w8a8 finetune with ``int8_backward``: the gradient reaches the
    fusion layers through the int8 dx of every projection. Three SGD steps
    against JAX's train_step (w8a8 bounds: loss 1e-3, tensors 5e-4)."""
    from medtsllm_tpu.data.pipeline import BatchPipeline as JaxBatchPipeline
    cfg = _cfg(tmp_path, {"int8_backward": True})
    jt, tt = _pair(cfg)
    blocks = tt.model.llm.blocks
    assert all(m.act_quant == "int8_bwd" for m in blocks.modules()
               if isinstance(m, ttf.QuantLinear))
    params = jax.tree.map(jnp.array, jt.params)
    state = jt.optimizer.init(params)
    trainable = [n for n, p in tt.model.named_parameters() if p.requires_grad]
    jpipe = JaxBatchPipeline(jt.train_dataset, cfg.training.batch_size, shuffle=True,
                             seed=cfg.setup.seed)
    for step, (jb, tb) in enumerate(zip(jpipe, tt.train_pipeline)):
        if step == 3:
            break
        ja, ta = jt.train_model_inputs(jb), tt.train_model_inputs(tb)
        params, state, loss_j = jt.train_step(params, state, ja, jnp.asarray(jb["valid"]),
                                              jax.random.PRNGKey(step))
        loss_t = tt.train_step(ta, ta["valid"])
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-3)
        want, got = from_flax(jax.device_get(params)), tt.model.state_dict()
        for k in trainable:
            np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=1e-4, atol=5e-4,
                                       err_msg=f"step {step}: {k}")
    # every projection made its [K, N] copy; none is in the state dict
    assert all("kn_copy" in dict(m.named_buffers()) for m in blocks.modules()
               if isinstance(m, ttf.QuantLinear))
    assert not any("kn_copy" in k for k in tt.model.state_dict())


def test_qlora_train_matches_jax(tmp_path):
    """QLoRA: ``load_in_4bit`` (absmax int4: K1's quantizer and K5's plain
    version, the 4-bit straight-through dx) with LoRA on q / v, through
    ``train()`` of both trainers (one epoch of SGD on the same shuffled
    batches): the losses within 1e-3, every trainable tensor within the
    w8a8 bounds (int4 codes flip as int8 ones do), the int4 weights and the
    rest of the backbone unmoved, every ``lora_b`` moved."""
    cfg = _cfg(tmp_path, {"load_in_8bit": False, "load_in_4bit": True}, lora=True)
    jt, tt = _pair(cfg)
    lora = {n for n, p in tt.model.named_parameters() if p.requires_grad and "lora_" in n}
    assert lora and {n.split(".")[-2] for n in lora} == {"q_proj", "v_proj"}
    assert isinstance(tt.model.llm.blocks[0].attn.q_proj.base, ttf.QuantLinear)
    frozen = {k: v.clone() for k, v in tt.model.state_dict().items()
              if k.startswith("llm.") and k not in lora}
    jax_losses = []
    log_step = jt.log_step
    jt.log_step = lambda loss, n: (jax_losses.append(loss), log_step(loss, n))
    with contextlib.redirect_stdout(None):
        jt.train()
        tt.train()
    assert len(tt.losses) == len(jax_losses) == len(tt.train_pipeline)
    np.testing.assert_allclose(tt.losses, jax_losses, rtol=1e-3)
    want, got = from_flax(jax.device_get(jt.params)), tt.model.state_dict()
    for k, p in tt.model.named_parameters():
        if p.requires_grad:
            np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=1e-4, atol=5e-4,
                                       err_msg=k)
    assert all(torch.equal(got[k], v) for k, v in frozen.items())
    assert all(not torch.equal(got[k], torch.zeros_like(got[k])) for k in lora
               if k.endswith("lora_b"))
