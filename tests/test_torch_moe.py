"""The MoE serving slice: the port's grouped matmul (K6's plain version),
MoEMLP and trainer against the JAX package on the same inputs.

Inputs are made from seeds with numpy; JAX's ``gmm`` runs in interpret mode
off the TPU, as its own tests and ``MoEMLP`` run it. Tolerances:
  - metadata, block picks and the s32 accumulators: equal;
  - ``gmm`` f32 outputs: 1e-6 x max (the same f32 products in the same
    order; XLA may contract a multiply-add, a few ulps);
  - the requantized codes of the gate+up form: at most 1 apart in at most
    1e-3 of them (a last-bit difference in silu can flip a rounding), and
    their scales 1e-6 relative;
  - MoEMLP (f32 activations): 1e-5 x max, 100x the measured ~2e-7;
  - the trainer slice: int8 projections may flip one activation rounding
    on a last-bit difference, so 2e-3 relative (test_torch_medtsllm.py's
    int8 tolerance).
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
from medtsllm_tpu.models.llm.transformer import QuantDense
from medtsllm_tpu.models.llm.transformer import TransformerDecoder as JaxDecoder
from medtsllm_tpu.ops.pallas import grouped_matmul as jgm
from test_torch_baseline_tasks import jax_get_trainer_jitted as jax_get_trainer
from medtsllm_tpu_torch.data import SyntheticDataset
from medtsllm_tpu_torch.models.llm.config import resolve_config
from medtsllm_tpu_torch.models.llm.transformer import MoEMLP, TransformerDecoder, moe_capacity
from medtsllm_tpu_torch.models.medtsllm import MedTsLLM, _resolve_moe
from medtsllm_tpu_torch.ops.kernels import grouped_matmul as gm
from medtsllm_tpu_torch.tasks import get_trainer
from medtsllm_tpu_torch.weights import from_flax

torch.set_num_threads(1)


# --------------------------------------------------------------------------
# block picks and metadata
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,target", [(5632, 1408), (2048, 1024), (64, 1024), (256, 1408),
                                      (2816, 1408), (384, 512), (100, 512)])
def test_pick_block_n_and_visits_match_jax(n, target):
    assert gm.pick_block_n(n, target) == jgm.pick_block_n(n, target)
    assert gm.gmm_visits(n, 8, 128) == jgm.gmm_visits(n, 8, 128)


@pytest.mark.parametrize("counts", [
    [130, 0, 7, 300],        # an empty expert between full ones
    [0, 0, 0, 437],          # every slot on the last expert
    [512, 0, 0, 0],          # every slot on the first, whole tiles
    [0, 0, 0, 0],            # nothing routed
    [1, 1, 1, 1],
], ids=["empty-middle", "all-last", "all-first", "none", "ones"])
def test_gmm_metadata_matches_jax(counts):
    c = np.asarray(counts, np.int32)
    V = gm.gmm_visits(max(int(c.sum()), 1), len(c), 128)
    want = jgm.gmm_metadata(jnp.asarray(c), 128, V)
    got = gm.gmm_metadata(torch.from_numpy(c), 128, V)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------------------------
# gmm's plain version against the JAX kernel (interpret mode)
# --------------------------------------------------------------------------

def _gmm_case(seed, counts, K, N, n_weights, n_chunks=0, bm=128):
    rs = np.random.RandomState(seed)
    E = len(counts)
    V = gm.gmm_visits(int(sum(counts)), E, bm)
    meta = jgm.gmm_metadata(jnp.asarray(np.asarray(counts, np.int32)), bm, V)[:2]
    R = V * bm
    xq = rs.randint(-127, 128, (R, K)).astype(np.int8)
    xs = ((rs.rand(n_chunks, 1, R) if n_chunks else rs.rand(R, 1)) * 1e-2).astype(np.float32)
    w = [rs.randint(-127, 128, (E, K, N)).astype(np.int8) for _ in range(n_weights)]
    ws = [(rs.rand(E, N) * 1e-2).astype(np.float32) for _ in range(n_weights)]
    jargs = (jnp.asarray(xq), jnp.asarray(xs), tuple(map(jnp.asarray, w)),
             tuple(map(jnp.asarray, ws)), *meta)
    targs = (torch.from_numpy(xq), torch.from_numpy(xs),
             [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1))) for a in w],
             [torch.from_numpy(s) for s in ws],
             *(torch.from_numpy(np.array(m)) for m in meta))
    return jargs, targs


# counts leave invalid tail visits (V counts one tail per expert)
_COUNTS = [200, 0, 37, 90]


def test_gmm_plain_gate_up_matches_jax():
    """(a) gate + up, fuse_silu + emit_quant, two 256-wide requant tiles."""
    jargs, targs = _gmm_case(0, _COUNTS, 256, 512, 2)
    want = jgm.gmm(*jargs, block_m=128, block_n=256, interpret=True, fuse_silu=True,
                   emit_quant=True)
    q, s = gm.gmm_plain(*targs, block_m=128, block_n=256, fuse_silu=True, emit_quant=True)
    assert q.dtype == torch.int8 and s.shape == (2, 1, targs[0].shape[0])
    dq = np.abs(q.numpy().astype(int) - np.asarray(want[0]).astype(int))
    assert dq.max() <= 1 and (dq > 0).mean() <= 1e-3
    np.testing.assert_allclose(s.numpy(), np.asarray(want[1]), rtol=1e-6)
    # invalid tail visits: zero codes, the 1e-10 floor
    n_real = int(targs[5].sum())
    assert not q[n_real * 128:].any()
    assert bool((s[..., n_real * 128:] == 1e-10).all())


def test_gmm_plain_down_chunked_matches_jax():
    """(b) one weight, chunked scales [KB, 1, R_pad], f32 out."""
    jargs, targs = _gmm_case(1, _COUNTS, 512, 256, 1, n_chunks=2)
    (want,) = jgm.gmm(*jargs, block_m=128, block_n=256, interpret=True)
    (got,) = gm.gmm_plain(*targs, block_m=128, block_n=256)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("n_weights", [1, 2])
def test_gmm_plain_rows_matches_jax(n_weights):
    """(c) 1-2 weights, per-row scales: f32 out, and the raw s32."""
    jargs, targs = _gmm_case(2, _COUNTS, 256, 384, n_weights)
    want = jgm.gmm(*jargs, block_m=128, block_n=128, interpret=True)
    got = gm.gmm_plain(*targs, block_m=128, block_n=128)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max())
    acc = gm.gmm_plain(*targs, block_m=128, block_n=128, out_dtype=torch.int32)
    xq, _, weights, _, ve, valid = targs
    for a, w in zip(acc, weights):  # the exact s32 of every valid row
        rows = torch.arange(xq.shape[0]) // 128
        want_acc = torch.zeros_like(a)
        for v in range(len(ve)):
            if valid[v]:
                sl = rows == v
                want_acc[sl] = xq[sl].int() @ w[ve[v]].int().T
        assert torch.equal(a, want_acc)


# the kernel's edge shapes: K tails short of a 128-byte stage, block_m 256,
# empty experts between full ones, chunk tails
_EDGE_CASES = {
    "k-tail-208": dict(counts=_COUNTS, K=208, N=256, n_weights=2, gate_up=True),
    "k-tail-336": dict(counts=_COUNTS, K=336, N=384, n_weights=2),
    "block_m-256": dict(counts=[300, 0, 129, 1000], K=256, N=512, n_weights=2, gate_up=True,
                        bm=256),
    "empty-between": dict(counts=[300, 0, 0, 260, 0, 129], K=256, N=256, n_weights=2,
                          gate_up=True),
    "chunk-tails": dict(counts=[300, 0, 0, 260], K=832, N=256, n_weights=1, n_chunks=4),
}


@pytest.mark.parametrize("case", sorted(_EDGE_CASES))
def test_gmm_plain_matches_jax_at_kernel_edges(case):
    """gmm_plain against the JAX gmm (interpret mode) at the shapes that the
    wgmma kernel's box tails, row tiles and visit lists reach: codes and
    scales under the gate+up law, f32 outputs within 1e-6 x max."""
    c = dict(_EDGE_CASES[case])
    gate_up, bm = c.pop("gate_up", False), c.pop("bm", 128)
    jargs, targs = _gmm_case(4, c["counts"], c["K"], c["N"], c["n_weights"],
                             c.get("n_chunks", 0), bm=bm)
    bn = 128
    if gate_up:
        want = jgm.gmm(*jargs, block_m=bm, block_n=bn, interpret=True, fuse_silu=True,
                       emit_quant=True)
        q, s = gm.gmm_plain(*targs, block_m=bm, block_n=bn, fuse_silu=True, emit_quant=True)
        dq = np.abs(q.numpy().astype(int) - np.asarray(want[0]).astype(int))
        assert dq.max() <= 1 and (dq > 0).mean() <= 1e-3
        np.testing.assert_allclose(s.numpy(), np.asarray(want[1]), rtol=1e-6)
        return
    want = jgm.gmm(*jargs, block_m=bm, block_n=bn, interpret=True)
    got = gm.gmm_plain(*targs, block_m=bm, block_n=bn)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("n_rows,n_cols,group_m", [
    (116, 44, 1), (116, 44, 8), (116, 16, 8), (116, 16, 16), (7, 3, 3), (25, 5, 4),
    (1, 1, 8), (3, 50, 2),
])
def test_gmm_tile_order_covers_every_tile_once(n_rows, n_cols, group_m):
    """The kernel's raster mirror visits each (row tile, column tile) once;
    within a group the row tile moves fastest; group_m 1 is row-major."""
    order = gm.gmm_tile_order(n_rows, n_cols, group_m)
    assert sorted(order) == [(r, c) for r in range(n_rows) for c in range(n_cols)]
    first = order[: min(group_m, n_rows)]
    assert first == [(r, 0) for r in range(min(group_m, n_rows))]
    if group_m == 1:
        assert order == [(r, c) for r in range(n_rows) for c in range(n_cols)]


@pytest.mark.parametrize("K,block_m,n_chunks,n_weights,w_bits,refused", [
    (2048, 128, 0, 2, 8, None),      # gate + up at the serving shape
    (5632, 128, 4, 1, 8, None),      # down: chunks of 1408
    (5632, 128, 4, 1, 4, None),
    (208, 256, 0, 2, 8, None),       # a K tail, block_m 256
    (96, 128, 2, 1, 8, None),        # chunks of 48
    (224, 128, 0, 1, 4, None),       # int4 halves of 112
    (64, 64, 0, 1, 8, "block_m"),
    (72, 128, 0, 1, 8, "16"),
    (96, 128, 4, 1, 8, "16"),        # chunks of 24
    (48, 128, 0, 1, 4, "16"),        # int4 halves of 24
    (256, 128, 2, 2, 8, "one weight"),
    (131088, 128, 0, 1, 8, "past"),
])
def test_gmm_kernel_shape_rule(K, block_m, n_chunks, n_weights, w_bits, refused):
    """The wrapper's rule for the shapes the kernel takes, a pure function
    (the card's wrapper raises its message before the launch)."""
    err = gm.kernel_shape_error(K, block_m, n_chunks, n_weights, w_bits)
    if refused is None:
        assert err is None
    else:
        assert err is not None and refused in err


def test_gmm_argument_checks():
    _, targs = _gmm_case(3, [5, 0], 64, 128, 1)
    with pytest.raises(ValueError, match="w_bits=4"):  # it takes packed [E, N, K/2]
        gm.gmm(*targs, block_n=128, w_bits=4)
    with pytest.raises(ValueError, match="emit_quant"):
        gm.gmm(*targs, block_n=128, emit_quant=True)
    with pytest.raises(ValueError, match="fuse_silu"):
        gm.gmm(*targs, block_n=128, fuse_silu=True)
    with pytest.raises(ValueError, match="block_n"):
        gm.gmm(*targs, block_n=96)


# --------------------------------------------------------------------------
# MoEMLP against JAX's on copied parameters
# --------------------------------------------------------------------------

def _jax_params(cfg, seed, x, quantize):
    """f32-init MoEMLP parameters, quantized expert-wise for w8 (the JAX
    tests' ``_w8a8_params``)."""
    pf = jax.jit(JaxMoEMLP(cfg).init)(jax.random.PRNGKey(seed + 1), jnp.asarray(x))["params"]
    if not quantize:
        return pf
    qp = {"gate": pf["gate"]}
    for name in ("w_gate", "w_up", "w_down"):
        qs = [QuantDense.quantize(np.asarray(pf[name][e]), bits=8)
              for e in range(cfg.n_experts)]
        qp[name + "_q"] = jnp.stack([jnp.asarray(q) for q, _ in qs])
        qp[name + "_scale"] = jnp.stack([jnp.asarray(s) for _, s in qs])
    return qp


_MOE_CASES = {
    # id: (preset, overrides, quantize, seed, (B, L), skewed)
    "dense-dropless": ("mixtral-tiny-128", dict(expert_capacity=0.0), 0, 7, (2, 16), False),
    "dense-capacity-drops": ("mixtral-tiny-128", dict(expert_capacity=0.25), 0, 7, (1, 64),
                             False),
    "w8-capacity-bmm": ("mixtral-tiny-128", dict(expert_capacity=0.0), 8, 7, (2, 16), False),
    "w8-grouped": ("mixtral-tiny-128", dict(moe_grouped=True), 8, 7, (2, 16), False),
    "w8-grouped-multi-tile": ("mixtral-tiny-128", dict(moe_grouped=True, d_ff=2816), 8, 13,
                              (1, 16), False),
    "w8-grouped-skewed": ("mixtral-tiny-128", dict(moe_grouped=True), 8, 3, (1, 24), True),
    "w8-grouped-fallback": ("mixtral-tiny", dict(moe_grouped=True), 8, 9, (1, 8), False),
}


@pytest.mark.parametrize("case", sorted(_MOE_CASES))
def test_moe_mlp_matches_jax(case):
    preset, over, quantize, seed, (B, L), skewed = _MOE_CASES[case]
    jcfg = dataclasses.replace(jax_resolve_config(preset)[0], **over)
    rs = np.random.RandomState(seed)
    if skewed:  # identical tokens: every one on the same top-2 experts
        x = np.tile(rs.randn(jcfg.d_model).astype(np.float32), (B, L, 1))
    else:
        x = rs.randn(B, L, jcfg.d_model).astype(np.float32)
    params = _jax_params(jcfg, seed, x, quantize)
    want = np.asarray(jax.jit(JaxMoEMLP(jcfg, quantize=quantize).apply)({"params": params},
                                                                        jnp.asarray(x)))
    moe = MoEMLP(dataclasses.replace(resolve_config(preset), **over), quantize).eval()
    moe.load_state_dict(from_flax(jax.device_get(params)))
    n = gm.GATE_UP.launches, gm.DOWN.launches
    with torch.no_grad():
        got = moe(torch.from_numpy(x)).numpy()
    assert (gm.GATE_UP.launches, gm.DOWN.launches) == n  # the CPU runs the plain version
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    if case == "dense-capacity-drops":
        assert moe_capacity(B * L, jcfg.n_experts, jcfg.n_experts_per_tok, 0.25) < B * L


def test_moe_grouped_matches_dropless_bmm_and_never_drops():
    """In the port alone: the grouped chain against the dropless capacity
    bmm (quantization noise: the chain requantizes per (row, F-tile)), and a
    skewed routing that a tight capacity drops but the chain does not."""
    preset = "mixtral-tiny-128"
    jcfg = jax_resolve_config(preset)[0]
    rs = np.random.RandomState(21)
    x = np.tile(rs.randn(jcfg.d_model).astype(np.float32), (1, 24, 1))
    x[0, :8] = rs.randn(8, jcfg.d_model)
    params = from_flax(jax.device_get(_jax_params(jcfg, 21, x, 8)))

    def run(**over):
        moe = MoEMLP(dataclasses.replace(resolve_config(preset), **over), 8).eval()
        moe.load_state_dict(params)
        with torch.no_grad():
            return moe(torch.from_numpy(x)).numpy()

    grouped, bmm = run(moe_grouped=True), run(expert_capacity=0.0)
    assert np.abs(grouped - bmm).max() / np.abs(bmm).max() < 0.02
    assert not np.allclose(run(expert_capacity=0.25), grouped, atol=1e-6)


def test_from_flax_moe_decoder_keys_and_shapes():
    cfg = jax_resolve_config("mixtral-tiny-128")[0]
    x = jnp.zeros((1, 4, cfg.d_model))
    shapes = jax.eval_shape(lambda: JaxDecoder(cfg, quantize=8).init(
        jax.random.PRNGKey(0), inputs_embeds=x))["params"]
    state = from_flax(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes))
    own = TransformerDecoder(resolve_config("mixtral-tiny-128"), 8).state_dict()
    assert set(state) == set(own)
    for k, t in own.items():
        assert state[k].shape == t.shape and state[k].dtype == t.dtype, k
    assert own["blocks.0.mlp.w_down_q"].shape == (4, 128, 256)  # [E, N, K]


# --------------------------------------------------------------------------
# from_config: expert_capacity and moe_grouped
# --------------------------------------------------------------------------

def _cfg(tmp_path, llm="mixtral-tiny-128", **llm_over):
    """test_torch_medtsllm.py's serving config on an MoE backbone."""
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
                "load_in_4bit": False, "load_in_8bit": True, **llm_over},
    }}
    return cfg


def test_from_config_resolves_moe(tmp_path):
    def build(cfg, device="cpu"):
        return MedTsLLM.from_config(cfg, SyntheticDataset(cfg, "train"), device).llm_cfg

    cfg = _cfg(tmp_path)
    assert build(cfg).moe_grouped is False  # "auto" is off on the CPU
    llm = cfg.models.medtsllm.llm
    assert _resolve_moe(resolve_config("moe-8x1b"), llm, 8,
                        torch.device("cuda")).moe_grouped is True  # on for the card
    assert _resolve_moe(resolve_config("moe-8x1b"), llm, 0,
                        torch.device("cuda")).moe_grouped is False  # dense experts
    llm["moe_grouped"] = True
    assert build(cfg).moe_grouped is True  # forced: the plain chain on the CPU
    llm["expert_capacity"] = 1.25
    assert build(cfg).expert_capacity == 1.25
    llm["load_in_8bit"] = False
    with pytest.raises(ValueError, match="integer experts"):
        build(cfg)
    dense = _cfg(tmp_path, llm="llama-tiny", moe_grouped=True)
    with pytest.raises(ValueError, match="not an enabled MoE"):
        build(dense)
    dense.models.medtsllm.llm["moe_grouped"] = False  # disabling is a no-op
    assert build(dense).moe_grouped is False
    with pytest.raises(ValueError, match="not a MoE"):
        build(_cfg(tmp_path, llm="llama-tiny", expert_capacity=1.25))
    # load_in_4bit wins over load_in_8bit: absmax int4 experts, integer experts
    int4 = build(_cfg(tmp_path, load_in_4bit=True))
    assert int4.quant4_codebook == "absmax" and int4.moe_grouped is False
    cfg = _cfg(tmp_path)
    cfg.setup["expert_parallel"] = 2
    with pytest.raises(NotImplementedError, match="\"Parallelism\""):
        build(cfg)


# --------------------------------------------------------------------------
# the slice: the JAX trainer and the port's, moe_grouped forced on both
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    cfg = _cfg(tmp_path_factory.mktemp("moe"), moe_grouped=True)
    cfg.setup.dtype = "float32"
    jt = jax_get_trainer("jax", cfg)
    tt = get_trainer("port", cfg, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    assert jt.model.llm_cfg.moe_grouped and tt.model.llm_cfg.moe_grouped
    return jt, tt


def test_slice_prompt_ids_equal(pair):
    jt, tt = pair
    for jb, tb in zip(jt.test_pipeline, tt.test_pipeline):
        ja, ta = jt.model_inputs(jb), tt.model_inputs(tb)
        np.testing.assert_array_equal(ja["prefix_ids"], ta["prefix_ids"])
        np.testing.assert_array_equal(ja["prompt_ids"], ta["prompt_ids"])


def test_slice_eval_dispatch_matches_jax(pair):
    jt, tt = pair
    jb, tb = next(iter(jt.test_pipeline)), next(iter(tt.test_pipeline))
    want = np.asarray(jt.eval_step(jt.params, jt.eval_model_inputs(jb)))
    got = tt.eval_dispatch(tb).float().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3 * np.abs(want).max())


def test_slice_cached_equals_uncached(pair):
    _, tt = pair
    batch = next(iter(tt.test_pipeline))
    cached = tt.eval_model_inputs(batch)
    assert "prefix_kv" in cached
    uncached = tt._to_device(tt.model_inputs(batch))
    np.testing.assert_allclose(tt.eval_step(cached).float().numpy(),
                               tt.eval_step(uncached).float().numpy(), rtol=1e-5, atol=1e-5)


def test_slice_test_scores_match_jax(pair):
    jt, tt = pair
    want, got = jt.test(), tt.test()
    assert set(got) == set(want) == {"test/mse", "test/mae"}
    for k in want:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3)
