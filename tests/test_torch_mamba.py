"""The Mamba serving slice of the port against the JAX package.

  1. the plain selective scan (what a CPU tensor takes) against the Pallas
     kernels in interpret mode (``_ssm_pallas``, ``_ssm_pallas_h0``) and
     the prefill form ``selective_ssm_final``;
  2. MambaBackbone (``mamba-tiny``) with the flax parameters copied by
     ``weights.from_flax``: forward, prefill states, forward from them;
  3. the slice: the JAX trainer and the port's trainer built from one
     ``mamba-tiny`` serving config (prompt-state cache), compared as
     tests/test_torch_medtsllm.py compares the llama slice.

Where trouble is likely (mamba.py:97-161 of the JAX package): dt_proj emits
the compute dtype and softplus runs in f32; B, C and xs are cast to f32
for the scan and y back to the compute dtype before the silu(z) gate; the
conv runs at the parameters' dtype, then ``+ conv_bias``; with a cached
prefix the conv reads the cached tail of the raw pre-activation xs, which
prefill zero-pads when the segment is shorter than K-1, and both states
broadcast from batch 1.

Tolerances: f32 differs in summation order and, cached against uncached,
in the scan's association (1e-5, as tests/test_mamba.py holds the JAX
kernels); bf16 storage by bf16 roundings (3e-2 relative).
"""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_config
from medtsllm_tpu.models.llm import mamba as jmamba
from medtsllm_tpu.models.llm.loader import _mamba_presets
from medtsllm_tpu.models.llm.tokenizer import _BPE_ASSET as JAX_BPE_ASSET
from medtsllm_tpu.ops.pallas import selective_scan as jss
from test_torch_baseline_tasks import jax_get_trainer_jitted as jax_get_trainer
from medtsllm_tpu_torch.models.llm import mamba as tmamba
from medtsllm_tpu_torch.models.llm.config import MAMBA_PRESETS, MambaConfig, resolve_config
from medtsllm_tpu_torch.models.llm.tokenizer import _BPE_ASSET
from medtsllm_tpu_torch.ops.kernels import selective_scan as kss
from medtsllm_tpu_torch.tasks import get_trainer
from medtsllm_tpu_torch.weights import from_flax

torch.set_num_threads(1)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


def _close(got, want, tol):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


# --------------------------------------------------------------------------
# 1. the scan
# --------------------------------------------------------------------------

def _scan_inputs(seed, B, L, E, N):
    rng = np.random.default_rng(seed)

    def mk(*s):
        return rng.standard_normal(s).astype(np.float32)
    return dict(dt=np.abs(mk(B, L, E)) * 0.1, A_T=-np.abs(mk(N, E)), Bs=mk(B, L, N),
                Cs=mk(B, L, N), xs=mk(B, L, E), D=mk(E))


_ORDER = ("dt", "A_T", "Bs", "Cs", "xs", "D")


@pytest.mark.parametrize("h0_rows", [0, 1, 2])
@pytest.mark.parametrize("N", [4, 8])
def test_plain_scan_matches_jax_kernels(N, h0_rows):
    """selective_ssm / selective_ssm_h0 (plain on the CPU) against the
    Pallas kernels in interpret mode: no h0 (K7), a batch-1 and a batch-B
    h0 (K8); L = 37 is not a multiple of the kernels' chunk. f32, 1e-5."""
    B, L, E = 2, 37, 128
    a = _scan_inputs(N + h0_rows, B, L, E, N)
    ja = [jnp.asarray(a[k]) for k in _ORDER]
    ta = [torch.from_numpy(a[k]) for k in _ORDER]
    if h0_rows:
        h0 = np.random.default_rng(7).standard_normal((h0_rows, N, E)).astype(np.float32)
        want = jss._ssm_pallas_h0(*ja, jnp.asarray(h0), chunk=16, block_e=128,
                                  interpret=True)
        got = kss.selective_ssm_h0(*ta, torch.from_numpy(h0))
    else:
        want = jss._ssm_pallas(*ja, chunk=16, block_e=128, interpret=True)
        got = kss.selective_ssm(*ta)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("with_h0", [False, True])
def test_plain_scan_final_matches_jax(with_h0):
    """The prefill form: y and the final state against JAX's
    selective_ssm_final (XLA); resuming from that state equals the whole
    sequence's scan."""
    B, P, L, E, N = 2, 9, 37, 128, 8
    a = _scan_inputs(11, B, P + L, E, N)
    h0 = (np.random.default_rng(3).standard_normal((1, N, E)).astype(np.float32)
          if with_h0 else None)
    ja = [jnp.asarray(a[k]) for k in _ORDER]
    ta = [torch.from_numpy(a[k]) for k in _ORDER]
    y_j, h_j = jss.selective_ssm_final(*ja, h0=None if h0 is None else jnp.asarray(h0))
    y_t, h_t = kss.selective_ssm_final(*ta, None if h0 is None else torch.from_numpy(h0))
    assert h_t.shape == (B, N, E)
    _close(y_t, y_j, 1e-5)
    _close(h_t, h_j, 1e-5)

    def cut(sl):
        return [t[:, sl] if t.dim() == 3 else t for t in ta]
    _, h_p = kss.selective_ssm_final(*cut(slice(0, P)),
                                     None if h0 is None else torch.from_numpy(h0))
    _close(kss.selective_ssm_h0(*cut(slice(P, None)), h_p), y_t[:, P:], 1e-5)


def test_scan_length_one_and_zero_state():
    """L = 1, the shortest eval segment; a zero h0 equals no h0."""
    a = _scan_inputs(5, 3, 1, 16, 4)
    ta = [torch.from_numpy(a[k]) for k in _ORDER]
    want = (torch.exp(ta[0][:, 0, None] * ta[1]) * 0 + (ta[0] * ta[4])[:, 0, None]
            * ta[2][:, 0, :, None])
    want = (want * ta[3][:, 0, :, None]).sum(1) + ta[5] * ta[4][:, 0]
    _close(kss.selective_ssm(*ta)[:, 0], want, 1e-6)
    _close(kss.selective_ssm_h0(*ta, torch.zeros(1, 4, 16)), kss.selective_ssm(*ta), 0)


# --------------------------------------------------------------------------
# 2. the backbone
# --------------------------------------------------------------------------

def _backbone_pair(storage, seed=0):
    jc, tc = _mamba_presets()["mamba-tiny"], MAMBA_PRESETS["mamba-tiny"]
    dt = None if storage == "float32" else JDT[storage]
    jm = jmamba.MambaBackbone(jc, dtype=dt, param_dtype=JDT[storage])
    x = jnp.asarray(np.random.default_rng(seed).standard_normal((2, 11, jc.d_model)),
                    jnp.float32)
    params = jax.jit(lambda k, a: jm.init(k, inputs_embeds=a))(
        jax.random.PRNGKey(seed), x)["params"]
    rng = np.random.default_rng(seed + 1)

    def fix(leaf):
        # non-trivial biases, conv bias and D (the init's zeros and ones would
        # hide a misplaced term); float leaves cast to the storage dtype, as
        # the trainers do
        if leaf.ndim == 1 and leaf.shape[0] != jc.d_model:
            leaf = jnp.asarray(rng.uniform(-0.5, 0.5, leaf.shape), jnp.float32)
        return leaf.astype(JDT[storage])
    params = jax.tree.map(fix, params)
    tm = tmamba.MambaBackbone(tc, 0, None if storage == "float32" else TDT[storage])
    tm.to(TDT[storage]).load_state_dict(from_flax(jax.device_get(params)))
    return jm, params, tm, x


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_backbone_forward_prefill_and_prefix(storage):
    """The forward; prefill states (conv tail and h) of a 5-token and of a
    2-token head (shorter than K-1: zero-padded tail); the forward from
    those states; and, within the port, cached against uncached."""
    jm, p, tm, x = _backbone_pair(storage)
    tol = _TOL[storage]
    tx = torch.from_numpy(np.array(x))
    run = jax.jit(lambda p, a: jm.apply({"params": p}, inputs_embeds=a))
    _close(tm(tx), run(p, x), tol)

    prefill = jax.jit(lambda p, a: jm.apply({"params": p}, a, method="prefill"))
    suffix = jax.jit(lambda p, a, kv: jm.apply({"params": p}, inputs_embeds=a,
                                               prefix_kv=kv))
    for P in (5, 2):
        st_j = prefill(p, x[:1, :P])
        st_t = tm.prefill(tx[:1, :P])
        for (cj, hj), (ct, ht) in zip(st_j, st_t):
            assert ct.shape == (1, 3, 128) and ht.shape == (1, 8, 128)
            assert ct.dtype == TDT[storage] and ht.dtype == torch.float32
            _close(ct, cj, tol)
            _close(ht, hj, tol)
        got = tm(tx[:, P:], prefix_kv=st_t)
        _close(got, suffix(p, x[:, P:], st_j), tol)
        if storage == "float32":
            full = tm(torch.cat([tx[:1, :P].expand(2, -1, -1), tx[:, P:]], dim=1))
            _close(got, full[:, P:], 1e-5)


def test_block_casts_in_bf16():
    """Under bf16 storage the residual stream stays f32 (promoted by the
    f32 input), the cached conv tail is bf16 and the scan state f32."""
    _, _, tm, x = _backbone_pair("bfloat16")
    block = tm.blocks[0]
    out, (tail, h) = block(torch.from_numpy(np.array(x))[:1], return_state=True)
    assert out.dtype == torch.float32 and tail.dtype == torch.bfloat16
    assert h.dtype == torch.float32
    assert block.A_log.dtype == block.D.dtype == torch.bfloat16


def test_presets_match_jax():
    assert set(MAMBA_PRESETS) == set(_mamba_presets())
    for name, jc in _mamba_presets().items():
        tc = resolve_config(name)
        assert isinstance(tc, MambaConfig)
        for f in dataclasses.fields(tc):
            # the 4-bit codebook is a field of the port's config only; JAX's
            # MambaBlock reads it by getattr with the "absmax" default
            want = (getattr(jc, f.name, "absmax") if f.name == "quant4_codebook"
                    else getattr(jc, f.name))
            assert getattr(tc, f.name) == want, (name, f.name)
        assert (tc.d_inner, tc.rank) == (jc.d_inner, jc.rank)
    assert resolve_config("mamba-130m", 2).n_layers == 2
    assert (MAMBA_PRESETS["mamba-130m"].d_inner, MAMBA_PRESETS["mamba-130m"].rank) == (1536, 48)


def test_tokenizer_asset_is_the_jax_packages():
    """The port's BPE asset is its own copy; the two must not drift."""
    assert _BPE_ASSET != JAX_BPE_ASSET and _BPE_ASSET.exists()
    assert (hashlib.sha256(_BPE_ASSET.read_bytes()).hexdigest()
            == hashlib.sha256(JAX_BPE_ASSET.read_bytes()).hexdigest())


# --------------------------------------------------------------------------
# 3. the slice
# --------------------------------------------------------------------------

def _cfg(tmp_path, dtype):
    """tests/test_prefix_cache.py's serving config on mamba-tiny."""
    cfg = make_config(task="reconstruction", model="medtsllm", hist=32, pred=32,
                      step=16)
    cfg["paths"] = {"logdir": str(tmp_path / "logs")}
    cfg.training.batch_size = 4
    cfg.datasets.synthetic.n_points = 384
    cfg.setup.dtype = dtype
    cfg["models"] = {"medtsllm": {
        "d_model": 16, "d_ff": 16, "n_heads": 4, "num_tokens": 32,
        "covariate_mode": "concat", "embedding_downsample_mode": "linear",
        "patching": {"patch_len": 8, "stride": 4},
        "prompting": {"dataset": True, "task": True, "clip": False,
                      "input_stats": True, "examples": False,
                      "input_stats_dim": 0, "input_stats_select": "all"},
        "llm": {"enabled": True, "llm": "mamba-tiny", "llm_layers": -1,
                "prefix_cache": True, "load_in_4bit": False,
                "load_in_8bit": False},
    }}
    return cfg


@pytest.fixture(scope="module", params=["float32", "bf16"])
def pair(request, tmp_path_factory):
    cfg = _cfg(tmp_path_factory.mktemp("logs"), request.param)
    jt = jax_get_trainer("jax", cfg)
    tt = get_trainer("port", cfg, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    return jt, tt, 1e-5 if request.param == "float32" else 3e-2


def test_slice_prompt_ids_equal(pair):
    jt, tt, _ = pair
    assert isinstance(tt.model.llm, tmamba.MambaBackbone)
    for jb, tb in zip(jt.test_pipeline, tt.test_pipeline):
        ja, ta = jt.model_inputs(jb), tt.model_inputs(tb)
        assert ja["prefix_ids"].ndim == 1
        np.testing.assert_array_equal(ja["prefix_ids"], ta["prefix_ids"])
        np.testing.assert_array_equal(ja["prompt_ids"], ta["prompt_ids"])


def test_slice_eval_dispatch_matches_jax_eval_step(pair):
    """The cached serving step on every test batch against JAX's."""
    jt, tt, tol = pair
    for jb, tb in zip(jt.test_pipeline, tt.test_pipeline):
        want = np.asarray(jt.eval_step(jt.params, jt.eval_model_inputs(jb)))
        got = tt.eval_dispatch(tb).float().numpy()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


def test_slice_cached_equals_uncached(pair):
    """The prompt head served from its (conv tail, SSM state) reproduces the
    forward with the head embedded in-graph (the scan from h = 0 over the
    whole prompt, as with prefix_cache = false), up to the scan's
    association; the uncached forward also matches JAX's."""
    jt, tt, tol = pair
    batch = next(iter(tt.test_pipeline))
    cached = tt.eval_model_inputs(batch)
    assert "prefix_kv" in cached and "prefix_ids" not in cached
    tail, h = cached["prefix_kv"][0]
    assert tail.shape[:2] == (1, 3) and h.shape[:2] == (1, 8)
    arrays = tt.model_inputs(batch)
    assert "prefix_ids" in arrays
    uncached = tt.eval_step(tt._to_device(arrays)).float().numpy()
    np.testing.assert_allclose(tt.eval_step(cached).float().numpy(), uncached,
                               rtol=tol, atol=tol * np.abs(uncached).max())
    want = np.asarray(jt.eval_step(jt.params, jt.model_inputs(
        next(iter(jt.test_pipeline)))))
    np.testing.assert_allclose(uncached, want, rtol=tol, atol=tol * np.abs(want).max())


def test_slice_test_scores_match_jax(pair):
    jt, tt, tol = pair
    want, got = jt.test(), tt.test()
    assert set(got) == {"test/mse", "test/mae"} == set(want)
    for k in want:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=tol)


def test_random_init_and_quantized_mamba_raises(tmp_path):
    """Random init follows the flax inits (A_log = log(1..N), D = 1) in the
    storage dtype; a quantized Mamba backbone (once refused) builds: its
    in_proj, x_proj and out_proj quantized, dt_proj dense, and serves
    (tests/test_torch_quant_mamba.py holds it against JAX's)."""
    tt = get_trainer("port", _cfg(tmp_path, "bf16"), device="cpu")
    sd = tt.model.state_dict()
    assert sd["llm.blocks.0.conv_kernel"].shape == (128, 1, 4)
    assert sd["llm.blocks.1.A_log"].dtype == torch.bfloat16
    np.testing.assert_allclose(_np(sd["llm.blocks.1.A_log"][5]),
                               np.log(np.arange(1, 9)), rtol=1e-2)
    assert torch.all(sd["llm.blocks.0.D"] == 1)
    assert all(np.isfinite(v) for v in tt.test().values())
    for key, bits in (("load_in_8bit", 8), ("load_in_4bit", 4)):
        cfg = _cfg(tmp_path, "bf16")
        cfg.models.medtsllm.llm[key] = True
        tq = get_trainer("x", cfg, device="cpu")
        block = tq.model.llm.blocks[0]
        assert all(getattr(block, n).bits == bits for n in ("in_proj", "x_proj", "out_proj"))
        assert isinstance(block.dt_proj, tmamba.Linear)
        assert all(np.isfinite(v) for v in tq.test().values())
    block = tmamba.MambaBackbone(MAMBA_PRESETS["mamba-tiny"], quantize=8).blocks[1]
    assert block.x_proj.weight_q.shape == (4 + 2 * 8, 128) and block.x_proj.bits == 8
