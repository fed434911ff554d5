"""The ``mixed`` dtype policy of the port against the JAX package, on the
CPU (llama-tiny, 2 layers, the shipped configs' task settings):

  (a) storage: the frozen backbone at bf16, every trainable parameter at
      f32, as the JAX trainer stores them; ``load_state_dict`` keeps each
      parameter's own dtype;
  (b) the residual stream: f32 in eval (bf16 projections and attention,
      the stream promoted back at each residual add) and bf16 in the train
      step, in both packages (JAX's read by ``nn.intercept_methods``);
  (c) eval: the predictions of segmentation, anomaly detection and
      4-class semantic segmentation within 2^-6 of the largest of JAX's
      mixed trainer's (four bf16 steps at the output's scale: the two
      frameworks round the bf16 matmuls' f32 sums each in its own order);
  (d) three mixed SGD train steps of the segmentation task against JAX's
      ``train_step``: the losses within 2^-7 relative; each trainable
      tensor within 2^-5 of its largest move over the three steps (the
      gradients are bf16 quantities, each framework rounding its bf16
      matmuls in its own order), mapping_layer.bias within 2^-4 (0.0495 of
      its move), the cause shown by (f); the reprogramming key bias, whose
      exact gradient is 0 (ROADMAP queue 3), moves by rounding noise only,
      under 1e-3 of the largest move;
  (e) the eval and train prompt-head caches kept apart (keys (ids, False)
      and (ids, True)): the eval cache embeds at f32, the train cache at
      bf16; the first layer's K/V bit-equal to JAX's, the later ones within
      2^-7 of the largest (eval) and 2^-6 (train: its residual stream is
      bf16, so a residual rounding that flips in layer 0 reaches layer 1's
      keys); the eval cache's tensors stay where they are across train steps
      and passes;
  (f) why mapping_layer.bias's move is the farthest from JAX's: its
      gradient is the sum over the d_llm rows of the cotangent of the
      mapping layer's output, and that sum cancels to under 2^-3 of the sum
      of its terms' magnitudes. The cotangents agree within 2^-5 of the
      largest (as every other leaf's gradient does); JAX's bias gradient is
      exactly that cotangent summed as XLA's CPU backend sums a bf16
      reduction (blocks of 32 rows added at bf16, then the blocks' sums),
      and the port's is exactly its own cotangent summed at f32 and rounded
      once. The cancellation magnifies both the cotangents' difference and
      the order of summation.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medtsllm_tpu.data.pipeline import BatchPipeline as JaxBatchPipeline
from test_torch_baseline_tasks import jax_get_trainer_jitted as jax_get_trainer
from medtsllm_tpu_torch.data import BatchPipeline
from medtsllm_tpu_torch.tasks import get_trainer
from medtsllm_tpu_torch.weights import from_flax
from test_torch_tasks import _cfg

torch.set_num_threads(1)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


@functools.cache
def _pair(case):
    cfg = _cfg(case, "mixed")
    cfg.training.optimizer = "sgd"
    cfg.training.learning_rate = 1e-2
    jt = jax_get_trainer("jax", cfg)
    tt = get_trainer("port", cfg, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    return case, jt, tt


@pytest.fixture(params=["anomaly", "semseg-4", "seg-boundary"])
def pair(request):
    return _pair(request.param)


def test_parameter_dtypes_match_jax(pair):
    """(a)"""
    _, jt, tt = pair
    want = from_flax(jax.device_get(jt.params))
    got = tt.model.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == want[k].dtype, k
        if v.is_floating_point():
            frozen = k.startswith("llm.")
            assert v.dtype == (torch.bfloat16 if frozen else torch.float32), k
            assert tt.model.get_parameter(k).requires_grad != frozen, k


def _block_inputs_jax(jt, arrays, params, training):
    seen = []

    def spy(next_fun, args, kwargs, context):
        if type(context.module).__name__ in ("Block", "RMSNorm"):
            seen.append((type(context.module).__name__, args[0].dtype))
        return next_fun(*args, **kwargs)
    with fnn.intercept_methods(spy):  # traced only: the dtypes, not the values
        jax.eval_shape(lambda p, a: jt.model.apply({"params": p}, a, training=training,
                                                   rngs={"dropout": jax.random.PRNGKey(0)}),
                       params, arrays)
    return seen


def test_residual_stream_dtypes(pair):
    """(b) each block's input and each RMSNorm's input, eval and train."""
    _, jt, tt = pair
    batch = next(iter(tt.train_pipeline))
    ja = jt.train_model_inputs(batch)
    j_eval = _block_inputs_jax(jt, jt.eval_model_inputs(batch), jt.params, False)
    j_train = _block_inputs_jax(jt, jt._cast_for_compute(ja),
                                jt._cast_for_compute(jt.params), True)
    assert {d for _, d in j_eval} == {np.dtype("float32")}
    assert {d for _, d in j_train} == {np.dtype(jnp.bfloat16)}
    te, ta = tt.eval_model_inputs(batch), tt.train_model_inputs(batch)  # the prefills
    state = {k: v.clone() for k, v in tt.model.state_dict().items()}
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, a: seen.append(a[0].dtype))
             for m in tt.model.llm.modules() if type(m).__name__ in ("Block", "RMSNorm")]
    try:
        tt.eval_step(te)
        n_eval = len(seen)
        tt.train_step(ta, ta["valid"])
        tt.load_state_dict(state)
    finally:
        for h in hooks:
            h.remove()
    assert n_eval == len(j_eval) and len(seen) - n_eval == len(j_train)
    assert set(seen[:n_eval]) == {torch.float32}
    assert set(seen[n_eval:]) == {torch.bfloat16}


def test_mixed_eval_matches_jax(pair):
    """(c) the eval step's window outputs on the val and test splits."""
    case, jt, tt = pair
    for pj, pt in ((jt.val_pipeline, tt.val_pipeline), (jt.test_pipeline, tt.test_pipeline)):
        want, got = jt.run_eval(pj)["pred"], tt.run_eval(pt)["pred"]
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -6 * np.abs(want).max())
    scores = tt.test()
    assert scores and all(np.isfinite(v) for v in scores.values())


def test_mixed_train_steps_match_jax():
    """(d) three SGD steps on the same shuffled batches, the prompt head
    served from the train cache on both sides; the backbone stays put."""
    _, jt, shared = _pair("seg-boundary")
    tt = get_trainer("port-train", shared.config, device="cpu")  # fresh optimizer state
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    params = jax.tree.map(jnp.array, jt.params)
    state = jt.optimizer.init(params)
    start = {k: v.clone() for k, v in tt.model.state_dict().items()}
    jpipe = JaxBatchPipeline(jt.train_dataset, 4, shuffle=True, seed=0)
    tpipe = BatchPipeline(tt.train_dataset, 4, shuffle=True, seed=0)
    moves = {}
    for step, (jb, tb) in enumerate(zip(jpipe, tpipe)):
        if step == 3:
            break
        np.testing.assert_array_equal(jb["index"], tb["index"])
        ja, ta = jt.train_model_inputs(jb), tt.train_model_inputs(tb)
        assert "prefix_kv" in ja and "prefix_kv" in ta
        params, state, loss_j = jt.train_step(params, state, ja, jnp.asarray(jb["valid"]),
                                              jax.random.PRNGKey(step))
        loss_t = tt.train_step(ta, ta["valid"])
        assert abs(float(loss_t) - float(loss_j)) <= 2.0 ** -7 * abs(float(loss_j))
    want = from_flax(jax.device_get(params))
    got = tt.model.state_dict()
    for k in got:
        if k.startswith("llm."):
            assert torch.equal(got[k], start[k]), k
            continue
        assert got[k].dtype == torch.float32
        moves[k] = np.abs(_np(want[k]) - _np(start[k])).max()
    largest = max(moves.values())
    for k, move in moves.items():
        err = np.abs(_np(got[k]) - _np(want[k])).max()
        if k.endswith("key_projection.bias"):
            port_move = np.abs(_np(got[k]) - _np(start[k])).max()
            assert max(move, port_move) <= 1e-3 * largest, k
            continue
        tol = 2.0 ** -4 if k == "mapping_layer.bias" else 2.0 ** -5  # (f)
        assert move > 0 and err <= tol * move, (k, err, move)


def _xla_cpu_bf16_sum(g):
    """The sum over axis 0 of a bf16 array as XLA's CPU backend reduces it:
    each block of 32 rows added row by row at bf16, then the blocks' sums."""
    def add_rows(rows):
        acc = torch.zeros(rows.shape[1:], dtype=torch.bfloat16)
        for r in rows:
            acc = acc + r
        return acc
    g = torch.tensor(g).bfloat16()
    return add_rows(torch.stack([add_rows(c) for c in torch.split(g, 32)])).float().numpy()


def test_mapping_bias_gradient_gap():
    """(f) the first train step's cotangent of the mapping layer's output
    and bias gradient, in both packages."""
    _, jt, shared = _pair("seg-boundary")
    tt = get_trainer("port-grad", shared.config, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    jb = next(iter(JaxBatchPipeline(jt.train_dataset, 4, shuffle=True, seed=0)))
    tb = next(iter(BatchPipeline(tt.train_dataset, 4, shuffle=True, seed=0)))
    ja, ta = jt.train_model_inputs(jb), tt.train_model_inputs(tb)
    ml = tt.model.mapping_layer
    d_llm, n_tokens = tt.model.llm_cfg.d_model, ml.out_features

    def loss_j(params, delta):  # JAX's train-step loss, delta added to the mapping output
        params = jax.tree.map(lambda x, l: jax.lax.stop_gradient(x) if l == "frozen" else x,
                              params, jt.param_label_tree)

        def add_delta(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            return out + delta.astype(out.dtype) if context.module.name == "mapping_layer" \
                else out
        with fnn.intercept_methods(add_delta):
            pred = jt.model.apply({"params": jt._cast_for_compute(params)},
                                  jt._cast_for_compute(ja), training=True,
                                  rngs={"dropout": jax.random.PRNGKey(0)})
        return jt.loss_fn(pred.astype(jnp.float32), ja, jnp.asarray(jb["valid"]))
    loss_jax, (grads, cot) = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1)))(
        jt.params, jnp.zeros((d_llm, n_tokens), jnp.float32))
    cot_j, bias_j = _np(cot), _np(grads["mapping_layer"]["bias"])

    seen = []

    def keep_cotangent(module, args, out):
        out.register_hook(lambda g: seen.append(g.float().numpy().copy()))
    hook = ml.register_forward_hook(keep_cotangent)
    try:
        loss_t = tt.train_step(ta, ta["valid"])
    finally:
        hook.remove()
    cot_t, bias_t = seen[0], _np(ml.bias.grad)
    assert abs(float(loss_t) - float(loss_jax)) <= 2.0 ** -7 * abs(float(loss_jax))
    assert cot_t.shape == cot_j.shape == (d_llm, n_tokens)
    np.testing.assert_allclose(cot_t, cot_j, rtol=0, atol=2.0 ** -5 * np.abs(cot_j).max())
    assert np.array_equal(bias_j, _xla_cpu_bf16_sum(cot_j))
    assert np.array_equal(bias_t, _np(torch.from_numpy(cot_t.sum(0)).bfloat16()))
    assert np.abs(cot_j.sum(0)).max() <= 2.0 ** -3 * np.abs(cot_j).sum(0).max()


def test_prefix_caches_kept_apart(pair):
    """(e)"""
    _, jt, tt = pair
    batch = next(iter(tt.test_pipeline))
    ids = tt.model_inputs(batch)["prefix_ids"]
    tt._prefix_kv_cache.clear()
    ev = tt.eval_model_inputs(batch)["prefix_kv"]
    tr = tt.train_model_inputs(batch)["prefix_kv"]
    assert set(tt._prefix_kv_cache) == {(ids.tobytes(), False), (ids.tobytes(), True)}
    assert ev[0][0].data_ptr() != tr[0][0].data_ptr()
    assert not all(torch.equal(a, b) for la, lb in zip(ev, tr) for a, b in zip(la, lb))
    ids_j = jnp.asarray(ids)
    for got, want, tol in ((ev, jt.prefill_program(False)(jt.params, ids_j), 2.0 ** -7),
                           (tr, jt.prefill_program(True)(jt.params, ids_j), 2.0 ** -6)):
        for i, (layer_t, layer_j) in enumerate(zip(got, want)):
            for t, j in zip(layer_t, layer_j):
                assert t.dtype == torch.bfloat16
                j = _np(j)
                if i == 0:  # the same bf16 embeddings through one projection
                    assert np.array_equal(_np(t), j)
                np.testing.assert_allclose(_np(t), j, rtol=0, atol=tol * np.abs(j).max())
    # a pass and a train step later, the eval cache is refilled where it lies
    ptr = ev[0][0].data_ptr()
    tt.run_eval(tt.test_pipeline)
    ta = tt.train_model_inputs(batch)
    state = {k: v.clone() for k, v in tt.model.state_dict().items()}
    tt.train_step(ta, ta["valid"])
    tt.load_state_dict(state)
    assert tt.eval_model_inputs(batch)["prefix_kv"][0][0].data_ptr() == ptr
