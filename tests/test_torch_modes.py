"""MedTsLLM's remaining modes in the port against the JAX package, on the
CPU: the five covariate modes besides ``concat`` and ``univariate``
(``independent``, ``interleave``, ``add``, ``weighted-average``,
``merge-end``), the ``truncate`` and ``average`` downsamples, and
``llm.enabled = false`` (llama-tiny cut to 1 layer; tests/test_torch_tasks.py's
anomaly-detection case: 3 features, history 32, batch 4). For each mode:

  (a) the state dict's keys equal ``weights.from_flax`` of JAX's tree, key
      for key: ``embedding_downsample_layer`` only under ``linear`` with the
      backbone enabled, ``feature_weighting`` only in its two modes,
      ``llm_replacement`` and an ``llm`` holding only ``wte`` with the
      backbone disabled (and no prompt built);
  (b) the f32 eval step on every test batch within 1e-5 of JAX's
      ``eval_step`` (dense f32: summation order only);
  (c) three SGD train steps against JAX's ``train_step`` at
      tests/test_torch_train.py's dense f32 bounds: the losses rtol 1e-5,
      every trainable tensor rtol 1e-4, atol 1e-5; the backbone unchanged;
  (d) ``run_eval`` under ``mixed`` within 2^-6 of the largest of JAX's
      mixed trainer's (tests/test_torch_mixed.py's bound).

Then the prefixes of the per-channel modes (``independent``,
``merge-end``: a row per channel through the backbone): on a clip dataset
(tests/test_torch_clip.py's ecgmit-seg cut, 3 features) the per-clip head
rows gathered from the bank are repeated per channel, the banked step equal
to the same batch with its head embedded and to JAX's ``eval_dispatch``
(1e-5); on mamba-tiny the cached (conv tail, SSM state) broadcast over the
channel rows equals the uncached forward and JAX's (1e-5). Last, a disabled
backbone builds no decoder block, at llama-tiny and at Llama-2-7B's width.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtsllm_tpu.data.pipeline import BatchPipeline as JaxBatchPipeline
from medtsllm_tpu.tasks import get_trainer as jax_get_trainer
from medtsllm_tpu_torch.data import get_dataset
from medtsllm_tpu_torch.models.medtsllm import MedTsLLM
from medtsllm_tpu_torch.tasks import get_trainer
from medtsllm_tpu_torch.weights import from_flax
from test_torch_clip import _cfg as _clip_cfg
from test_torch_tasks import _cfg as _task_cfg

torch.set_num_threads(1)

# mode -> the [models.medtsllm] entries it sets
MODES = {
    "independent": {"covariate_mode": "independent"},
    "interleave": {"covariate_mode": "interleave"},
    "add": {"covariate_mode": "add"},
    "weighted-average": {"covariate_mode": "weighted-average"},
    "merge-end": {"covariate_mode": "merge-end"},
    "truncate": {"embedding_downsample_mode": "truncate"},
    "average": {"embedding_downsample_mode": "average"},
    "llm-disabled": {"llm.enabled": False},
}


def _set(cfg, **entries):
    mc = cfg.models.medtsllm
    for key, value in entries.items():
        *path, leaf = key.split(".")
        node = mc
        for p in path:
            node = node[p]
        node[leaf] = value
    return cfg


def _cfg(mode, dtype="float32", llm="llama-tiny"):
    cfg = _set(_task_cfg("anomaly", dtype), **MODES[mode],
               **{"llm.llm": llm, "llm.llm_layers": 1})
    cfg.training.optimizer = "sgd"
    cfg.training.learning_rate = 1e-2
    return cfg


@functools.cache
def _pair(mode, dtype="float32", llm="llama-tiny"):
    cfg = _cfg(mode, dtype, llm)
    jt = jax_get_trainer("jax", cfg)
    tt = get_trainer("port", cfg, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    return cfg, jt, tt


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1.0))


# --------------------------------------------------------------------------
# (a) the parameter tree
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
def test_state_dict_keys_match_flax(mode):
    _, jt, tt = _pair(mode)
    got = tt.model.state_dict()
    assert set(got) == set(from_flax(jax.device_get(jt.params)))
    top = {k.split(".")[0] for k in got}
    enabled = mode != "llm-disabled"
    assert ("embedding_downsample_layer" in top) == (enabled and mode not in (
        "truncate", "average"))
    assert ("feature_weighting" in top) == (mode in ("merge-end", "weighted-average"))
    assert ("llm_replacement" in top) == (not enabled)
    assert ({k for k in got if k.startswith("llm.")} == {"llm.wte"}) == (not enabled)
    # K3's queries: C * d_model wide under concat only
    concat = tt.model.covariate_mode == "concat"
    assert tt.model.reprogramming_layer.query_projection.in_features == (48 if concat else 16)
    if mode == "interleave":
        assert tt.model.n_patches == 3 * tt.model.base_n_patches
    batch = next(iter(tt.test_pipeline))
    assert ("prompt_ids" in tt.model_inputs(batch)) == enabled


# --------------------------------------------------------------------------
# (b) the f32 eval step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
def test_eval_matches_jax(mode):
    _, jt, tt = _pair(mode)
    n = 0
    for jb, tb in zip(jt.test_pipeline, tt.test_pipeline):
        want = np.asarray(jt.eval_step(jt.params, jt.eval_model_inputs(jb)))
        got = tt.eval_dispatch(tb).numpy()
        assert got.shape == want.shape == (4, 32, 3)
        _close(got, want)
        n += 1
    assert n >= 2


# --------------------------------------------------------------------------
# (c) three SGD train steps
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
def test_train_steps_match_jax(mode):
    cfg, jt, _ = _pair(mode)
    tt = get_trainer("port-train", cfg, device="cpu")  # its own copy to train
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    params = jax.tree.map(jnp.array, jt.params)
    state = jt.optimizer.init(params)
    backbone = {k: v.clone() for k, v in tt.model.state_dict().items() if k.startswith("llm.")}
    jpipe = JaxBatchPipeline(jt.train_dataset, cfg.training.batch_size, shuffle=True,
                             seed=cfg.setup.seed)
    for step, (jb, tb) in enumerate(zip(jpipe, tt.train_pipeline)):
        if step == 3:
            break
        np.testing.assert_array_equal(jb["index"], tb["index"])
        ja, ta = jt.train_model_inputs(jb), tt.train_model_inputs(tb)
        params, state, loss_j = jt.train_step(params, state, ja, jnp.asarray(jb["valid"]),
                                              jax.random.PRNGKey(step))
        loss_t = tt.train_step(ta, ta["valid"])
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
        want = from_flax(jax.device_get(params))
        got = tt.model.state_dict()
        trained = [k for k in got if not k.startswith("llm.")]
        for k in trained:
            np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {step}: {k}")
    for k, v in backbone.items():
        assert torch.equal(tt.model.state_dict()[k], v), k


# --------------------------------------------------------------------------
# (d) eval under mixed
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
def test_mixed_eval_matches_jax(mode):
    _, jt, tt = _pair(mode, "mixed")
    assert all(v.dtype == (torch.bfloat16 if k.startswith("llm.") else torch.float32)
               for k, v in tt.model.state_dict().items() if v.is_floating_point())
    want, got = jt.run_eval(jt.test_pipeline)["pred"], tt.run_eval(tt.test_pipeline)["pred"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -6 * np.abs(want).max())


# --------------------------------------------------------------------------
# the prefixes of the per-channel modes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["independent", "merge-end"])
def test_banked_head_per_channel(mode):
    """On a clip dataset: the bank's [B, ...] rows repeated per channel (K2
    with B * C per-row prefixes) give the embedded head's outputs and
    JAX's."""
    cfg = _set(_clip_cfg("ecgmit-seg"), covariate_mode=mode)
    jt = jax_get_trainer("jax", cfg)
    tt = get_trainer("port", cfg, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    seen = []
    llm_forward = tt.model.llm.forward
    tt.model.llm.forward = lambda x, prefix_kv=None: (
        seen.append((x.shape[0], None if prefix_kv is None else prefix_kv[0][0].shape[0]))
        or llm_forward(x, prefix_kv=prefix_kv))
    n = 0
    for jb, tb in zip(jt.test_pipeline, tt.test_pipeline):
        kind, arrays = tt.eval_prepare(tb)
        assert kind == "banked"
        banked = tt.eval_step(arrays).numpy()
        embedded = tt.eval_step(tt._to_device(tt.model_inputs(tb))).numpy()
        _close(banked, embedded)
        _close(banked, np.asarray(jt.eval_dispatch(jb)))
        n += 1
    assert n >= 2
    # 4 windows x 3 channels: 12 rows, the banked step's prefix per row
    assert seen[0] == (12, 12) and seen[1] == (12, None)


def test_mamba_cached_state_per_channel():
    """mamba-tiny under ``independent``: the one-row cached state broadcast
    over the B * C rows equals the uncached forward and JAX's."""
    _, jt, tt = _pair("independent", llm="mamba-tiny")
    for i, (jb, tb) in enumerate(zip(jt.test_pipeline, tt.test_pipeline)):
        if i == 2:
            break
        cached = tt.eval_model_inputs(tb)
        assert cached["prefix_kv"][0][1].shape[0] == 1
        got = tt.eval_step(cached).numpy()
        _close(got, tt.eval_step(tt._to_device(tt.model_inputs(tb))).numpy())
        _close(got, np.asarray(jt.eval_step(jt.params, jt.eval_model_inputs(jb))))


def test_disabled_backbone_builds_no_decoder():
    """``llm.enabled = false`` holds no decoder-block parameter: at
    llama-tiny, and at Llama-2-7B's width (built on the meta device) the
    fusion layers, the MLP and the 32000 x 4096 word embeddings only."""
    _, _, tt = _pair("llm-disabled")
    assert not any(".blocks." in k or k.startswith("llm.norm") for k in tt.model.state_dict())
    cfg = _cfg("llm-disabled")
    cfg.models.medtsllm.llm.llm = "meta-llama/Llama-2-7b-hf"
    with torch.device("meta"):
        model = MedTsLLM.from_config(cfg, get_dataset(cfg, "train"), "cpu")
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(p.numel() for name, p in model.named_parameters()
                    if not name.startswith("llm.")) + 32000 * 4096
    assert n < 0.3e9  # the 32 blocks alone would hold 6.5 G
