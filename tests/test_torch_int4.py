"""The int4 serving slice: the split-halves int4 format, K5's plain version
(``w4a8_matmul_plain``), K6's ``w_bits=4`` plain form, the 4-bit
``QuantLinear`` and ``MoEMLP``, ``from_config`` and two trainer slices,
each against the JAX package on the same inputs.

Inputs are made from seeds with numpy; the JAX Pallas kernels run in
interpret mode, as the JAX package's own tests run them off the TPU.
Tolerances:
  - packing and accumulators: equal; the requantized codes of the gate+up
    form at most 1 apart in at most 1e-3 of them, their scales 1e-6
    relative (test_torch_moe.py's w8 law: silu differs in the last bit);
  - K5's plain version against the JAX kernel and its XLA oracle: f32 and
    bf16 outputs equal (the same integers, the same ``(acc * xs) * ws``);
  - ``gmm`` f32 outputs: 1e-6 x max (the same f32 products in the same
    order; XLA may contract a multiply-add, a few ulps);
  - ``QuantLinear``, absmax (even and odd K): 1e-6 relative at f32 (the
    integers equal, the rescale in one order); nf4 / fp4: 1e-5 (an f32
    matmul of table values, summed in another order);
  - ``MoEMLP`` (f32 activations): 1e-5 x max;
  - the trainer slices: test_torch_medtsllm.py's w8a8 tolerance, 2e-3
    relative (an int8 rounding of an activation may flip on a last-bit
    difference).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_config
from medtsllm_tpu.models.llm.loader import resolve_config as jax_resolve_config
from medtsllm_tpu.models.llm.transformer import MoEMLP as JaxMoEMLP
from medtsllm_tpu.models.llm import transformer as jtf
from medtsllm_tpu.models.llm.transformer import QuantDense
from medtsllm_tpu.models.llm.transformer import TransformerDecoder as JaxDecoder
from medtsllm_tpu.ops.pallas import grouped_matmul as jgm
from medtsllm_tpu.ops.pallas import quant_matmul as jqm
from test_torch_baseline_tasks import jax_get_trainer_jitted as jax_get_trainer
from medtsllm_tpu_torch.data import SyntheticDataset
from medtsllm_tpu_torch.models.llm.config import resolve_config
from medtsllm_tpu_torch.models.llm.transformer import MoEMLP, QuantLinear, TransformerDecoder
from medtsllm_tpu_torch.models.medtsllm import MedTsLLM, _resolve_moe
from medtsllm_tpu_torch.ops.kernels import grouped_matmul as gm
from medtsllm_tpu_torch.ops.kernels import w4a8 as k5
from medtsllm_tpu_torch.ops.kernels import w8a8 as k1
from medtsllm_tpu_torch.tasks import get_trainer
from medtsllm_tpu_torch.weights import from_flax

torch.set_num_threads(1)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))  # a writable copy


# --------------------------------------------------------------------------
# the format and K5's plain version
# --------------------------------------------------------------------------

@pytest.mark.parametrize("K", [7, 8, 33, 256])
def test_pack4_split_matches_jax(K):
    """The port packs along the last axis of [N, K]; JAX along the first of
    [K, N]: the same bytes, transposed. Odd K pads the last low nibble."""
    q = np.random.RandomState(K).randint(-8, 8, (K, 12)).astype(np.int8)
    want = np.asarray(jqm.pack4_split(q))
    packed = k5.pack4_split(_t(q.T))
    np.testing.assert_array_equal(packed.numpy().T, want)
    unpacked = k5.unpack4_split(_t(want.T), K).numpy().T
    np.testing.assert_array_equal(unpacked, np.asarray(jqm.unpack4_split(jnp.asarray(want), K)))
    np.testing.assert_array_equal(unpacked, q)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w4a8_plain_matches_jax_kernel_and_oracle(dtype):
    """tests/test_pallas_kernels.py's case (M 40 not a multiple of the
    block: the kernel pads M), and the raw s32 against the XLA dot."""
    rng = np.random.default_rng(1)
    M, K, N = 40, 64, 32
    xq = rng.integers(-127, 128, size=(M, K)).astype(np.int8)
    q = rng.integers(-8, 8, size=(K, N)).astype(np.int8)
    packed = jqm.pack4_split(q)
    xs = rng.uniform(1e-3, 1e-1, (M, 1)).astype(np.float32)
    ws = rng.uniform(1e-3, 1e-1, (N,)).astype(np.float32)
    jargs = (jnp.asarray(xq), jnp.asarray(packed), jnp.asarray(xs), jnp.asarray(ws))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    kernel = jqm.w4a8_matmul_pallas(*jargs, out_dtype=jdt, block_m=16, block_n=16,
                                    block_k2=16, interpret=True)
    oracle = jqm.w4a8_matmul_reference(*jargs, out_dtype=jdt)
    targs = (_t(xq), _t(packed.T), _t(xs[:, 0]), _t(ws))
    got = k5.w4a8_matmul_plain(*targs, tdt).float().numpy()
    np.testing.assert_array_equal(got, np.asarray(kernel.astype(jnp.float32)))
    np.testing.assert_array_equal(got, np.asarray(oracle.astype(jnp.float32)))
    # the CPU wrapper is the plain version; the integers are the exact dot
    np.testing.assert_array_equal(k5.w4a8_gemm(*targs, tdt).float().numpy(), got)
    acc = k5.w4a8_gemm(*targs, torch.int32).numpy()
    np.testing.assert_array_equal(acc, xq.astype(np.int32) @ q.astype(np.int32))


# --------------------------------------------------------------------------
# QuantLinear at 4 bits against QuantDense(bits=4)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("codebook,K,rtol", [("absmax", 64, 1e-6), ("absmax", 33, 1e-6),
                                             ("nf4", 64, 1e-5), ("fp4", 64, 1e-5)],
                         ids=["absmax", "absmax-odd-K", "nf4", "fp4"])
def test_quant_linear_4bit_matches_quant_dense(codebook, K, rtol):
    rs = np.random.RandomState(K)
    N = 48
    w = (rs.randn(K, N) * 0.02).astype(np.float32)
    kq, scale = QuantDense.quantize(w, bits=4, codebook=codebook)
    x = rs.randn(2, 5, K).astype(np.float32)
    dense = QuantDense(features=N, use_bias=False, bits=4, codebook=codebook)
    want = np.asarray(jax.jit(dense.apply)({"params": {"kernel_q": jnp.asarray(kq),
                                                       "scale": jnp.asarray(scale)}},
                                           jnp.asarray(x)))
    lin = QuantLinear(K, N, None, bits=4, codebook=codebook)
    lin.load_state_dict({"weight_q": _t(kq.T), "scale": _t(scale)})
    n = k5.w4a8_gemm.launches
    with torch.no_grad():
        got = lin(torch.from_numpy(x)).numpy()
    assert k5.w4a8_gemm.launches == n  # the CPU runs the plain version
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())
    if codebook == "absmax":  # the integers: activation codes and accumulators
        xf = jnp.asarray(x.reshape(-1, K))
        x_scale = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0, 1e-10)
        jxq = jnp.round(xf / x_scale).astype(jnp.int8)
        jacc = jax.lax.dot_general(jxq, QuantDense.unpack4(jnp.asarray(kq), K),
                                   (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
        xq, xs = k1.quantize_rows_plain(torch.from_numpy(x.reshape(-1, K)))
        np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
        acc = k1.int8_matmul_plain(xq, k5.unpack4_split(_t(kq.T), K))
        np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))


def test_quant_linear_4bit_refuses_training():
    """Training through 4-bit projections is ported: the straight-through dx
    of ``_act_quant_matmul`` at 4 bits (the weight unpacked, ``(g * scale)
    @ W``) against ``jax.vjp``, K even (K5) and odd (K1 on the unpacked
    weight), within 1e-5 x max (a float matmul summed in another order)."""
    rs = np.random.RandomState(4)
    for K in (64, 63):
        x = rs.randn(3, K).astype(np.float32)
        g = rs.randn(3, 16).astype(np.float32)
        kq = np.asarray(jqm.pack4_split(rs.randint(-7, 8, (K, 16)).astype(np.int8)))
        scale = (rs.rand(16) * 1e-2).astype(np.float32)
        _, vjp = jax.vjp(lambda xx: jtf._act_quant_matmul(xx, jnp.asarray(kq),
                                                          jnp.asarray(scale), 4),
                         jnp.asarray(x))
        (want,) = vjp(jnp.asarray(g))
        lin = QuantLinear(K, 16, None, bits=4)
        lin.load_state_dict({"weight_q": _t(kq.T), "scale": torch.from_numpy(scale)})
        xt = torch.from_numpy(x).requires_grad_()
        lin(xt).backward(torch.from_numpy(g))
        want = np.asarray(want)
        np.testing.assert_allclose(xt.grad.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


# --------------------------------------------------------------------------
# gmm's w_bits=4 plain form against the JAX kernel (interpret mode)
# --------------------------------------------------------------------------

def _gmm4_case(seed, counts, K, N, n_weights, n_chunks=0, bm=128):
    rs = np.random.RandomState(seed)
    E = len(counts)
    V = gm.gmm_visits(int(sum(counts)), E, bm)
    meta = jgm.gmm_metadata(jnp.asarray(np.asarray(counts, np.int32)), bm, V)[:2]
    R = V * bm
    xq = rs.randint(-127, 128, (R, K)).astype(np.int8)
    xs = ((rs.rand(n_chunks, 1, R) if n_chunks else rs.rand(R, 1)) * 1e-2).astype(np.float32)
    q = [rs.randint(-8, 8, (E, K, N)).astype(np.int8) for _ in range(n_weights)]
    w = [np.stack([np.asarray(jqm.pack4_split(a[e])) for e in range(E)]) for a in q]
    ws = [(rs.rand(E, N) * 1e-2).astype(np.float32) for _ in range(n_weights)]
    jargs = (jnp.asarray(xq), jnp.asarray(xs), tuple(map(jnp.asarray, w)),
             tuple(map(jnp.asarray, ws)), *meta)
    targs = (_t(xq), _t(xs), [_t(a.transpose(0, 2, 1)) for a in w], [_t(s) for s in ws],
             *(_t(m) for m in meta))
    return jargs, targs


_COUNTS = [200, 0, 37, 90]  # leaves invalid tail visits


def test_gmm4_gate_up_matches_jax():
    """(a) gate + up on packed int4, fuse_silu + emit_quant, two 256-wide
    requant tiles. XLA's silu and torch's differ in the last bit, so the w8
    law of test_torch_moe.py: codes at most 1 apart in at most 1e-3 of them,
    scales 1e-6 relative."""
    jargs, targs = _gmm4_case(0, _COUNTS, 256, 512, 2)
    want = jgm.gmm(*jargs, block_m=128, block_n=256, interpret=True, fuse_silu=True,
                   emit_quant=True, w_bits=4)
    q, s = gm.gmm_plain(*targs, block_m=128, block_n=256, fuse_silu=True, emit_quant=True,
                        w_bits=4)
    dq = np.abs(q.numpy().astype(int) - np.asarray(want[0]).astype(int))
    assert dq.max() <= 1 and (dq > 0).mean() <= 1e-3
    np.testing.assert_allclose(s.numpy(), np.asarray(want[1]), rtol=1e-6)
    n_real = int(targs[5].sum())
    assert not q[n_real * 128:].any() and bool((s[..., n_real * 128:] == 1e-10).all())


def test_gmm4_down_chunked_matches_jax():
    """(b) one packed weight, K 2816 in 4 chunks: chunks 0-1 read the high
    nibbles, chunks 2-3 the low ones (the contraction crosses the halves)."""
    jargs, targs = _gmm4_case(1, _COUNTS, 2816, 256, 1, n_chunks=4)
    (want,) = jgm.gmm(*jargs, block_m=128, block_n=256, interpret=True, w_bits=4)
    (got,) = gm.gmm_plain(*targs, block_m=128, block_n=256, w_bits=4)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("n_weights", [1, 2])
def test_gmm4_rows_matches_jax(n_weights):
    """(c) per-row scales, full K (hi + lo summed in s32): f32 out, and the
    raw s32 against the exact product of the unpacked weights."""
    jargs, targs = _gmm4_case(2, _COUNTS, 256, 384, n_weights)
    want = jgm.gmm(*jargs, block_m=128, block_n=128, interpret=True, w_bits=4)
    got = gm.gmm_plain(*targs, block_m=128, block_n=128, w_bits=4)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max())
    acc = gm.gmm_plain(*targs, block_m=128, block_n=128, out_dtype=torch.int32, w_bits=4)
    xq, _, weights, _, ve, valid = targs
    rows = torch.arange(xq.shape[0]) // 128
    for a, w in zip(acc, weights):
        want_acc = torch.zeros_like(a)
        for v in range(len(ve)):
            if valid[v]:
                want_acc[rows == v] = xq[rows == v].int() @ k5.unpack4_split(
                    w[ve[v]], xq.shape[1]).int().T
        assert torch.equal(a, want_acc)


@pytest.mark.parametrize("K,n_chunks", [(2816, 2), (832, 4), (224, 0), (352, 0)],
                         ids=["2-chunks", "4-chunk-tails", "k-tail-224", "k-tail-352"])
def test_gmm4_plain_matches_jax_at_kernel_edges(K, n_chunks):
    """w_bits=4 at the wgmma kernel's edges: 2 chunks (one per nibble half),
    4 chunks of 208 (ragged chunk tails), and full-K halves of 112 / 176
    packed bytes; f32 outputs within 1e-6 x max, an empty expert between
    full ones."""
    jargs, targs = _gmm4_case(5, [300, 0, 0, 260], K, 256, 1, n_chunks=n_chunks)
    (want,) = jgm.gmm(*jargs, block_m=128, block_n=128, interpret=True, w_bits=4)
    (got,) = gm.gmm_plain(*targs, block_m=128, block_n=128, w_bits=4)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_gmm4_argument_checks():
    _, targs = _gmm4_case(3, [5, 0], 64, 128, 1)
    xq, xs, w, ws, ve, valid = targs
    with pytest.raises(ValueError, match="w_bits=4"):  # int8-shaped weights
        gm.gmm(xq, xs, [k5.unpack4_split(w[0], 64)], ws, ve, valid, block_n=128, w_bits=4)
    with pytest.raises(ValueError, match="even chunk count"):
        gm.gmm(xq, torch.ones(1, 1, xq.shape[0]), w, ws, ve, valid, block_n=128, w_bits=4)


# --------------------------------------------------------------------------
# MoEMLP(quantize=4) against JAX's on copied parameters
# --------------------------------------------------------------------------

_MOE4_CASES = {
    # id: (overrides, codebook, seed, (B, L))
    "absmax-capacity-bmm": (dict(expert_capacity=0.0), "absmax", 7, (2, 16)),
    "absmax-grouped": (dict(moe_grouped=True, d_ff=2816), "absmax", 17, (1, 16)),
    "nf4-bmm": (dict(expert_capacity=0.0), "nf4", 5, (2, 16)),
    "fp4-bmm": (dict(expert_capacity=0.0), "fp4", 5, (2, 16)),
    # d_ff 256 is one F-tile: an odd chunk count, so both take the bmm
    "absmax-grouped-odd-chunks": (dict(moe_grouped=True), "absmax", 9, (1, 16)),
}


@pytest.mark.parametrize("case", sorted(_MOE4_CASES))
def test_moe_mlp_4bit_matches_jax(case):
    over, cb, seed, (B, L) = _MOE4_CASES[case]
    over = dict(over, quant4_codebook=cb)
    jcfg = dataclasses.replace(jax_resolve_config("mixtral-tiny-128")[0], **over)
    x = np.random.RandomState(seed).randn(B, L, jcfg.d_model).astype(np.float32)
    pf = jax.jit(JaxMoEMLP(jcfg).init)(jax.random.PRNGKey(seed + 1), jnp.asarray(x))["params"]
    params = {"gate": pf["gate"]}
    for name in ("w_gate", "w_up", "w_down"):  # the loader's load_in_4bit recipe
        qs = [QuantDense.quantize(np.asarray(pf[name][e]), bits=4, codebook=cb)
              for e in range(jcfg.n_experts)]
        params[name + "_q"] = jnp.stack([jnp.asarray(q) for q, _ in qs])
        params[name + "_scale"] = jnp.stack([jnp.asarray(s) for _, s in qs])
    want = np.asarray(jax.jit(JaxMoEMLP(jcfg, quantize=4).apply)({"params": params},
                                                                 jnp.asarray(x)))
    moe = MoEMLP(dataclasses.replace(resolve_config("mixtral-tiny-128"), **over), 4).eval()
    moe.load_state_dict(from_flax(jax.device_get(params)))
    n = gm.GATE_UP_W4.launches, gm.DOWN_W4.launches, k5.w4a8_gemm.launches
    calls = []
    real_gmm = gm.gmm

    def spy(*a, **kw):
        calls.append(kw["w_bits"])
        return real_gmm(*a, **kw)

    from medtsllm_tpu_torch.models.llm import transformer as tfm
    tfm.gmm = spy
    try:
        with torch.no_grad():
            got = moe(torch.from_numpy(x)).numpy()
    finally:
        tfm.gmm = real_gmm
    # the grouped chain ran (on packed int4) exactly where JAX's does
    assert calls == ([4, 4] if case == "absmax-grouped" else [])
    assert (gm.GATE_UP_W4.launches, gm.DOWN_W4.launches, k5.w4a8_gemm.launches) == n
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_from_flax_4bit_decoder_keys_and_shapes():
    """Packed kernel_q and w_*_q leaves land in the port's packed layouts."""
    for preset in ("llama-tiny", "mixtral-tiny-128"):
        cfg = jax_resolve_config(preset)[0]
        shapes = jax.eval_shape(lambda: JaxDecoder(cfg, quantize=4).init(
            jax.random.PRNGKey(0), inputs_embeds=jnp.zeros((1, 4, cfg.d_model))))["params"]
        state = from_flax(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes))
        own = TransformerDecoder(resolve_config(preset), 4).state_dict()
        assert set(state) == set(own)
        for k, t in own.items():
            assert state[k].shape == t.shape and state[k].dtype == t.dtype, k
    assert own["blocks.0.mlp.w_down_q"].shape == (4, 128, 128)  # [E, N, ceil(K/2)]
    assert own["blocks.0.attn.q_proj.weight_q"].shape == (128, 64)


# --------------------------------------------------------------------------
# from_config
# --------------------------------------------------------------------------

def _cfg(tmp_path, llm="llama-tiny", **llm_over):
    """test_torch_medtsllm.py's serving config with a 4-bit backbone."""
    cfg = make_config(task="reconstruction", model="medtsllm", hist=32, pred=32, step=16)
    cfg["paths"] = {"logdir": str(tmp_path / "logs")}
    cfg.training.batch_size = 4
    cfg.datasets.synthetic.n_points = 192
    cfg["models"] = {"medtsllm": {
        "d_model": 16, "d_ff": 16, "n_heads": 4, "num_tokens": 32,
        "covariate_mode": "concat", "embedding_downsample_mode": "linear",
        "patching": {"patch_len": 8, "stride": 4},
        "prompting": {"dataset": True, "task": True, "clip": False,
                      "input_stats": True, "examples": False,
                      "input_stats_dim": 0, "input_stats_select": "all",
                      "cache_order": True},
        "llm": {"enabled": True, "llm": llm, "llm_layers": -1, "prefix_cache": True,
                "load_in_4bit": True, "load_in_8bit": False, **llm_over},
    }}
    return cfg


def test_from_config_4bit(tmp_path):
    def build(cfg, device="cpu"):
        return MedTsLLM.from_config(cfg, SyntheticDataset(cfg, "train"), device)

    for qt, cb in (("int4", "absmax"), ("linear", "absmax"), ("NF4", "nf4"), ("fp4", "fp4")):
        model = build(_cfg(tmp_path, quant_type=qt))
        assert model.llm_cfg.quant4_codebook == cb
        proj = model.llm.blocks[0].attn.q_proj
        assert proj.bits == 4 and proj.codebook == cb and proj.weight_q.shape == (64, 32)
    assert build(_cfg(tmp_path)).llm_cfg.quant4_codebook == "absmax"  # int4 by default
    with pytest.raises(ValueError, match="quant_type"):
        build(_cfg(tmp_path, quant_type="int3"))
    # weight-only absmax int4 (int8_matmul = false): the unpacked weight in a
    # float matmul (tests/test_torch_quant_train.py holds it to QuantDense)
    proj = build(_cfg(tmp_path, int8_matmul=False)).llm.blocks[0].attn.q_proj
    assert proj.act_quant is False and proj.codebook == "absmax"
    build(_cfg(tmp_path, quant_type="nf4", int8_matmul=False))  # codebooks are weight-only
    # a 4-bit Mamba (once refused): its three projections at the codebook
    for qt, cb in (("int4", "absmax"), ("nf4", "nf4")):
        mamba = build(_cfg(tmp_path, llm="mamba-tiny", quant_type=qt))
        assert mamba.llm_cfg.quant4_codebook == cb
        proj = mamba.llm.blocks[0].x_proj
        assert proj.bits == 4 and proj.codebook == cb and proj.weight_q.shape == (20, 64)
    # the MoE: absmax int4 experts are integer experts
    moe = _cfg(tmp_path, llm="mixtral-tiny-128")
    assert build(moe).llm_cfg.moe_grouped is False  # "auto" is off on the CPU
    llm = moe.models.medtsllm.llm
    cfg4 = dataclasses.replace(resolve_config("moe-8x1b"), quant4_codebook="absmax")
    assert _resolve_moe(cfg4, llm, 4, torch.device("cuda")).moe_grouped is True
    nf4 = dataclasses.replace(cfg4, quant4_codebook="nf4")
    assert _resolve_moe(nf4, llm, 4, torch.device("cuda")).moe_grouped is False
    llm["moe_grouped"] = True
    assert build(moe).llm_cfg.moe_grouped is True  # forced: the plain chain on the CPU
    llm["quant_type"] = "fp4"
    with pytest.raises(ValueError, match="integer experts"):
        build(moe)


# --------------------------------------------------------------------------
# the slices: the JAX trainer and the port's at int4
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["llama-tiny", "mixtral-tiny-128"])
def pair(request, tmp_path_factory):
    cfg = _cfg(tmp_path_factory.mktemp("int4"), llm=request.param)
    jt = jax_get_trainer("jax", cfg)
    tt = get_trainer("port", cfg, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    return jt, tt


def test_slice_test_scores_match_jax(pair):
    jt, tt = pair
    assert tt.model.llm.blocks[0].attn.q_proj.bits == 4
    jb, tb = next(iter(jt.test_pipeline)), next(iter(tt.test_pipeline))
    want = np.asarray(jt.eval_step(jt.params, jt.eval_model_inputs(jb)))
    got = tt.eval_dispatch(tb).float().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3 * np.abs(want).max())
    want, got = jt.test(), tt.test()
    assert set(got) == set(want) == {"test/mse", "test/mae"}
    for k in want:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3)
