"""The training slice of the port against the JAX package, on the CPU.

  (a) ``selective_ssm_bounds_plain`` (K9's plain version) against the Pallas
      ``_ssm_pallas_with_bounds`` in interpret mode: y and the chunk-start
      states, with and without h0, chunk 8 and 16, L not a multiple of it;
  (b) ``selective_ssm_bwd_plain`` (K10's) against ``_ssm_pallas_bwd`` in
      interpret mode, all five outputs in order; K10's decomposition
      (``selective_ssm_bwd_split``) against both;
  (c) the scan's autograd Function: six gradients against ``jax.vjp`` of
      ``selective_ssm`` and ``selective_ssm_h0``;
  (d) the STE backward of the w8a8 projection against ``jax.vjp`` of
      ``_act_quant_matmul``, and K2's dq/dk/dv against ``jax.vjp`` of
      ``fused_rope_attention``;
  (e) the losses; (f) the optimizer's updates; (g) the shuffled pipeline;
  (h) the trajectory: three ``train_step``s of the port against the JAX
      trainer's on copied weights, mamba-tiny and llama-tiny (dense and
      w8a8), prompt cache on and off;
  (i) cached train gradients equal uncached; (j) dropout.

Tolerances: the scan in f32 differs in summation order and association
(y, hb 1e-5; gradients 1e-4 of the largest, as tests/test_mamba.py holds
the Pallas backward); dense f32 train steps: losses rtol 1e-5, trainable
parameters rtol 1e-4, atol 1e-5. The w8a8 path turns last-bit activation
differences into int8 rounding flips (ROADMAP queue 3): a flip moves one
activation by one int8 step (1/127 of its row's absmax) and the gradients
through it by about as much, ~1e-2 relative, so at lr 1e-2 a parameter
may move ~1e-4 apart per step: w8a8 losses rtol 1e-3, parameters atol
5e-4 over three steps.

The trajectory runs SGD (momentum 0.9, nesterov). Adam divides each
gradient element by its own magnitude, so an element whose exact gradient
is zero moves by ~lr on rounding noise alone, and the two runs part there
by design: the reprogramming key projection's bias is one (the softmax
over keys ignores a constant added to every score of a query). Adam's
update itself is held to optax in (f).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conftest import make_config
from medtsllm_tpu.data.pipeline import BatchPipeline as JaxBatchPipeline
from medtsllm_tpu.models.llm.transformer import _act_quant_matmul
from medtsllm_tpu.ops.pallas import rope_attention as jrope
from medtsllm_tpu.ops.pallas import selective_scan as jss
from medtsllm_tpu.runtime.optim import Optimizer as JaxOptimizer
from test_torch_baseline_tasks import jax_get_trainer_jitted as jax_get_trainer
from medtsllm_tpu.tasks import losses as jlosses
from medtsllm_tpu_torch.config import Config
from medtsllm_tpu_torch.data import BatchPipeline
from medtsllm_tpu_torch.models.llm.transformer import QuantLinear
from medtsllm_tpu_torch.ops.kernels import rope_attention as k2
from medtsllm_tpu_torch.ops.kernels import selective_scan as kss
from medtsllm_tpu_torch.ops.kernels import w8a8 as k1
from medtsllm_tpu_torch.runtime.optim import Optimizer
from medtsllm_tpu_torch.tasks import get_trainer, losses
from medtsllm_tpu_torch.weights import from_flax

torch.set_num_threads(1)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


def _close(got, want, rtol, atol_scale):
    """|got - want| <= rtol |want| + atol_scale max|want| (max >= 1e-6)."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol,
                               atol=atol_scale * max(np.abs(want).max(), 1e-6))


# --------------------------------------------------------------------------
# (a)-(c) the scan's training pair
# --------------------------------------------------------------------------

_ORDER = ("dt", "A_T", "Bs", "Cs", "xs", "D")


def _scan_inputs(seed, B=2, L=37, E=128, N=4, h0_rows=0):
    rng = np.random.default_rng(seed)

    def mk(*s):
        return rng.standard_normal(s).astype(np.float32)
    a = dict(dt=np.abs(mk(B, L, E)) * 0.1, A_T=-np.abs(mk(N, E)), Bs=mk(B, L, N),
             Cs=mk(B, L, N), xs=mk(B, L, E), D=mk(E), g=mk(B, L, E))
    a["h0"] = mk(h0_rows, N, E) if h0_rows else None
    return a


def _j(a, *keys):
    return [None if a[k] is None else jnp.asarray(a[k]) for k in keys]


def _t(a, *keys):
    return [None if a[k] is None else torch.from_numpy(a[k]) for k in keys]


@pytest.mark.parametrize("h0_rows", [0, 1, 2])
@pytest.mark.parametrize("chunk", [8, 16])
def test_bounds_plain_matches_pallas(chunk, h0_rows):
    """(a) y and hb [B, ceil(37 / chunk), N, E], f32, 1e-5."""
    a = _scan_inputs(chunk + h0_rows, h0_rows=h0_rows)
    y_j, hb_j = jss._ssm_pallas_with_bounds(*_j(a, *_ORDER), chunk=chunk, block_e=128,
                                            interpret=True, h0=_j(a, "h0")[0])
    y_t, hb_t = kss.selective_ssm_bounds(*_t(a, *_ORDER), *_t(a, "h0"), chunk=chunk)
    assert hb_t.shape == hb_j.shape == (2, -(-37 // chunk), 4, 128)
    _close(y_t, y_j, 1e-5, 1e-5)
    _close(hb_t, hb_j, 1e-5, 1e-5)


@pytest.mark.parametrize("chunk", [8, 16])
def test_bwd_plain_matches_pallas(chunk):
    """(b) (ddt, dx_ssm, dB, dC, dA_T) in that order, from the same hb;
    N = 4 so no two outputs shape-match by accident. 1e-4 of the largest."""
    a = _scan_inputs(30 + chunk)
    jin = _j(a, *_ORDER)
    _, hb = jss._ssm_pallas_with_bounds(*jin, chunk=chunk, block_e=128, interpret=True)
    want = jss._ssm_pallas_bwd(*jin[:5], jnp.asarray(a["g"]), hb, chunk=chunk,
                               block_e=128, interpret=True)
    hb = torch.from_numpy(np.array(hb))
    got = kss.selective_ssm_bwd(*_t(a, *_ORDER[:5], "g"), hb, chunk)
    assert len(got) == 5
    for g_, w_ in zip(got, want):
        assert tuple(g_.shape) == w_.shape
        _close(g_, w_, 1e-4, 1e-5)
    # A frozen: no dA_T, the rest unchanged
    frozen = kss.selective_ssm_bwd(*_t(a, *_ORDER[:5], "g"), hb, chunk, need_dA=False)
    assert frozen[4] is None
    for g_, f_ in zip(got[:4], frozen[:4]):
        assert torch.equal(g_, f_)


# (B, L, E, N, chunk): one token; under one 16-token sub-chunk; one past
# it; the train window (9 chunks); a recorded chunk longer than the
# kernel's sub-chunk (32), so its first sub-chunk is reached by a forward
# from the chunk start. E is no multiple of 128 nor of the kernel's block
# (512 / N channels), so the last block and its slab are partial
_SPLIT_CASES = [(2, 1, 200, 16, 16), (2, 15, 200, 8, 16), (2, 17, 96, 4, 16),
                (2, 144, 130, 16, 16), (1, 40, 72, 16, 32)]


@pytest.mark.parametrize("B,L,E,N,chunk", _SPLIT_CASES)
def test_bwd_split_matches_plain_and_pallas(B, L, E, N, chunk):
    """K10's decomposition (``selective_ssm_bwd_split``: the states in
    groups of 4, sub-chunks of up to 16 tokens run forward once from the
    recorded chunk start, per-block dB/dC slabs) against the plain version
    and ``_ssm_pallas_bwd`` in interpret mode, from the same chunk-start
    states (an h0, so dA_T is not zero at L 1); the wrapper without dA_T.
    1e-4 of the largest, as (b)."""
    a = _scan_inputs(L + N, B=B, L=L, E=E, N=N, h0_rows=1)
    jin = _j(a, *_ORDER)
    _, hb = jss._ssm_pallas_with_bounds(*jin, chunk=chunk, block_e=E, interpret=True,
                                        h0=_j(a, "h0")[0])
    want = jss._ssm_pallas_bwd(*jin[:5], jnp.asarray(a["g"]), hb, chunk=chunk, block_e=E,
                               interpret=True)
    hb = torch.from_numpy(np.array(hb))
    tin = _t(a, *_ORDER[:5], "g")
    got = kss.selective_ssm_bwd_split(*tin, hb, chunk)
    plain = kss.selective_ssm_bwd_plain(*tin, hb, chunk)
    for g_, p_, w_ in zip(got, plain, want):
        assert tuple(g_.shape) == tuple(p_.shape) == w_.shape
        _close(g_, p_, 1e-4, 1e-5)
        _close(g_, w_, 1e-4, 1e-5)
    frozen = kss.selective_ssm_bwd(*tin, hb, chunk, need_dA=False)
    assert frozen[4] is None
    for f_, p_ in zip(frozen[:4], plain[:4]):
        assert torch.equal(f_, p_)


def _jit_vjp(fn, g, *args):
    """(fn(*args), the vjp of g), computed as one jitted program."""
    def run(g, *args):
        y, vjp = jax.vjp(fn, *args)
        return y, vjp(g)
    return jax.jit(run)(g, *args)


@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_autograd_matches_jax_vjp(with_h0):
    """(c) the six gradients of selective_ssm / selective_ssm_h0 (h0 a
    constant) against jax.vjp of the JAX functions (their custom_vjps off
    the TPU); y too."""
    a = _scan_inputs(50, h0_rows=1 if with_h0 else 0)
    jin, g = _j(a, *_ORDER), jnp.asarray(a["g"])
    if with_h0:
        h0 = jnp.asarray(a["h0"])
        fn = lambda *x: jss.selective_ssm_h0(*x, h0)  # noqa: E731
    else:
        fn = jss.selective_ssm
    y_j, want = _jit_vjp(fn, g, *jin)
    tin = [t.clone().requires_grad_() for t in _t(a, *_ORDER)]
    n9, n10 = kss.selective_ssm_bounds.launches, kss.selective_ssm_bwd.launches
    y_t = (kss.selective_ssm_h0(*tin, torch.from_numpy(a["h0"])) if with_h0
           else kss.selective_ssm(*tin))
    y_t.backward(torch.from_numpy(a["g"]))
    # the CPU runs the plain versions: no CUDA launch is counted
    assert (kss.selective_ssm_bounds.launches, kss.selective_ssm_bwd.launches) == (n9, n10)
    _close(y_t, y_j, 1e-5, 1e-5)
    for t, w in zip(tin, want):
        _close(t.grad, w, 1e-4, 1e-5)


def test_scan_without_grad_stays_on_the_serving_path():
    """Under no_grad the scan is not the autograd Function (K7/K8 on the
    card, as in serving)."""
    a = _scan_inputs(3)
    tin = [t.requires_grad_() for t in _t(a, *_ORDER)]
    with torch.no_grad():
        assert kss.selective_ssm(*tin).grad_fn is None
    assert kss.selective_ssm(*tin).grad_fn is not None


# --------------------------------------------------------------------------
# (d) the w8a8 STE backward and K2's backward
# --------------------------------------------------------------------------

def test_ste_backward_matches_jax_vjp():
    """(d) dx = (g * scale) @ W_q against jax.vjp of _act_quant_matmul (f32,
    summation order only: 1e-5); the forward integers are JAX's. The int8
    weight and its scale get no gradient."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32)
    kq = rng.integers(-127, 128, (64, 48)).astype(np.int8)  # JAX [K, N]
    scale = (rng.random(48) * 1e-2).astype(np.float32)
    g = rng.standard_normal((3, 7, 48)).astype(np.float32)
    y_j, vjp = jax.vjp(lambda v: _act_quant_matmul(v, jnp.asarray(kq), jnp.asarray(scale),
                                                   8, False), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    st = torch.from_numpy(scale)
    y_t = k1.act_quant_matmul(xt, torch.from_numpy(kq.T.copy()), st)
    y_t.backward(torch.from_numpy(g))
    _close(y_t, y_j, 1e-5, 1e-6)
    _close(xt.grad, dx_j, 1e-5, 1e-6)


@pytest.mark.parametrize("prefix", [False, True])
def test_rope_attention_backward_matches_jax_vjp(prefix):
    """(d) dq, dk, dv of the K2 wrapper against jax.vjp of
    fused_rope_attention off the TPU; the prefix K/V gets no gradient. f32,
    1e-5."""
    rng = np.random.default_rng(9)
    B, L, H, D, P = 2, 11, 4, 16, 5
    q, k, v, g = (rng.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(4))
    pk, pv = (rng.standard_normal((1, H, P, D)).astype(np.float32) for _ in range(2))
    off = P if prefix else 0
    cos, sin = k2.rope_tables(torch.arange(off, off + L), D, 10000.0)
    jp = (jnp.asarray(pk), jnp.asarray(pv)) if prefix else (None, None)
    y_j, want = _jit_vjp(lambda a, b, c: jrope.fused_rope_attention(
        a, b, c, jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()), *jp, D ** -0.5),
        jnp.asarray(g), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    tp = (torch.from_numpy(pk).requires_grad_(), torch.from_numpy(pv)) if prefix \
        else (None, None)
    y_t = k2.rope_attention(tq, tk, tv, cos, sin, *tp, D ** -0.5)
    y_t.backward(torch.from_numpy(g))
    _close(y_t, y_j, 1e-5, 1e-5)
    for t, w in zip((tq, tk, tv), want):
        _close(t.grad, w, 1e-5, 1e-5)
    if prefix:
        assert tp[0].grad is None


# --------------------------------------------------------------------------
# (e) losses, (f) the optimizer, (g) the pipeline
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mse", "mae", "smooth_l1"])
def test_losses_match_jax(name):
    """(e) over valid rows only (the padded rows are garbage), 1e-6."""
    rng = np.random.default_rng(2)
    pred = (rng.standard_normal((5, 8, 3)) * 2).astype(np.float32)
    x = rng.standard_normal((5, 8, 3)).astype(np.float32)
    valid = np.array([True, True, False, True, False])
    want = jlosses.build_loss(name, "reconstruction")(
        jnp.asarray(pred), {"x_enc": jnp.asarray(x)}, jnp.asarray(valid))
    xt = torch.from_numpy(x).requires_grad_()
    got = losses.build_loss(name, "reconstruction")(
        torch.from_numpy(pred), {"x_enc": xt}, torch.from_numpy(valid))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert not got.requires_grad  # the target carries no gradient
    assert float(losses.mse(torch.zeros(2, 3), torch.ones(2, 3),
                            torch.zeros(2, dtype=torch.bool))) == 0.0
    # a loss the task does not take is refused as JAX refuses it (a task
    # still to be ported is refused by get_trainer)
    with pytest.raises(ValueError, match="Invalid loss"):
        losses.build_loss("bce", "reconstruction")


@pytest.mark.parametrize("opt,sched,clip", [
    ("adam", "none", 0.0), ("adamw", "cosine", 0.0), ("sgd", "linear", 0.5),
    ("adam", "cosine", 0.3)])
def test_optimizer_matches_jax(opt, sched, clip):
    """(f) two steps in each of four epochs (warmup 1 epoch, min factor
    0.1) on the same parameters and gradients as the JAX Optimizer (optax),
    f32: rtol 1e-5, atol 2e-6 (torch adds the update in one rounding,
    optax forms it and then adds it: about one f32 ulp of |p| ~ 1 per step,
    over 8 steps)."""
    cfg = make_config(**{"training.optimizer": opt, "training.learning_rate": 1e-2,
                         "training.lr_scheduler": sched, "training.epochs": 4,
                         "training.lr_warmup_epochs": 1, "training.lr_min_factor": 0.1,
                         "training.grad_clip_norm": clip})
    rng = np.random.default_rng(1)
    init = {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}
    jopt = JaxOptimizer(cfg, None, num_iterations=8)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in init.items()}
    frozen = torch.zeros(3, requires_grad=False)
    topt = Optimizer(Config(cfg.to_dict()), [tp["w"], tp["b"], frozen])
    assert len(topt.params) == 2  # only trainable parameters reach it
    for epoch in range(4):
        state = jopt.set_epoch(state, epoch)
        topt.set_epoch(epoch)
        assert topt.get_last_lr() == pytest.approx(jopt.get_last_lr())
        for _ in range(2):
            grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                     for k, v in init.items()}
            updates, state = jopt.update({k: jnp.asarray(g) for k, g in grads.items()},
                                         state, jp)
            jp = optax.apply_updates(jp, updates)
            for k, g in grads.items():
                tp[k].grad = torch.from_numpy(g)
            topt.step()
            for k in init:
                np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), rtol=1e-5,
                                           atol=2e-6)


def test_unported_optimizer_options_raise():
    """The options once refused (ranger21, ranger_classic, grad_accum_steps)
    now build, and two micro-steps of each move the parameter as JAX's
    Optimizer does (f32, rtol 1e-5: tests/test_torch_optim_modes.py holds
    them over ten steps)."""
    for key, val in (("training.optimizer", "ranger21"),
                     ("training.optimizer", "ranger_classic"),
                     ("training.grad_accum_steps", 2)):
        cfg = make_config(**{key: val, "training.learning_rate": 1e-2})
        init = np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3)
        jopt = JaxOptimizer(cfg, None, num_iterations=4)
        jp = {"w": jnp.asarray(init)}
        state = jopt.init(jp)
        tw = torch.from_numpy(init.copy()).requires_grad_()
        topt = Optimizer(Config(cfg.to_dict()), [tw], num_iterations=4)
        for g in (0.5, -1.5):
            grad = np.full((2, 3), g, np.float32) * init
            updates, state = jopt.update({"w": jnp.asarray(grad)}, state, jp)
            jp = optax.apply_updates(jp, updates)
            tw.grad = torch.from_numpy(grad)
            topt.step()
            topt.end_micro_step()
            np.testing.assert_allclose(_np(tw), np.asarray(jp["w"]), rtol=1e-5, atol=1e-7)
        assert not torch.equal(tw.detach(), torch.from_numpy(init))


def test_shuffled_pipeline_order_matches_jax(tmp_path):
    """(g) the same windows in the same order, epoch after epoch, for the
    same seed; the padded last batch and its valid mask too."""
    cfg = _cfg(tmp_path, "llama-tiny", False)
    tt = get_trainer("port", cfg, device="cpu")
    jp = JaxBatchPipeline(tt.train_dataset, cfg.training.batch_size, shuffle=True,
                          seed=cfg.setup.seed)
    assert len(tt.train_dataset) % cfg.training.batch_size  # a padded last batch
    orders = []
    for _ in range(2):
        tb_all, jb_all = list(tt.train_pipeline), list(jp)
        assert len(tb_all) == len(jb_all) == len(tt.train_pipeline)
        for tb, jb in zip(tb_all, jb_all):
            for k in ("x_enc", "index", "valid"):
                np.testing.assert_array_equal(tb[k], jb[k])
        orders.append(np.concatenate([b["index"] for b in tb_all]))
    assert not np.array_equal(orders[0], orders[1])  # a new order each epoch
    plain = np.concatenate([b["index"] for b in BatchPipeline(tt.train_dataset, 4)])
    assert np.array_equal(plain[:len(tt.train_dataset)], np.arange(len(tt.train_dataset)))


# --------------------------------------------------------------------------
# (h) the trajectory against the JAX trainer
# --------------------------------------------------------------------------

def _cfg(tmp_path, llm, quant, dropout=0.0):
    """tests/test_prefix_cache.py's config (cache_order head), trainable."""
    cfg = make_config(task="reconstruction", model="medtsllm", hist=32, pred=32, step=16)
    cfg["paths"] = {"logdir": str(tmp_path / "logs")}
    cfg.training.batch_size = 4
    cfg.training.dropout = dropout
    cfg.datasets.synthetic.n_points = 200
    cfg["models"] = {"medtsllm": {
        "d_model": 16, "d_ff": 16, "n_heads": 4, "num_tokens": 32,
        "covariate_mode": "concat", "embedding_downsample_mode": "linear",
        "patching": {"patch_len": 8, "stride": 4},
        "prompting": {"dataset": True, "task": True, "clip": False,
                      "input_stats": True, "examples": False,
                      "input_stats_dim": 0, "input_stats_select": "all",
                      "cache_order": True},
        "llm": {"enabled": True, "llm": llm, "llm_layers": -1,
                "prefix_cache": True, "load_in_4bit": False,
                "load_in_8bit": quant},
    }}
    return cfg


# backbone -> (llm, w8a8, loss rtol, parameter rtol, parameter atol)
_BACKBONES = {"mamba-tiny": ("mamba-tiny", False, 1e-5, 1e-4, 1e-5),
              "llama-tiny": ("llama-tiny", False, 1e-5, 1e-4, 1e-5),
              "llama-tiny-w8a8": ("llama-tiny", True, 1e-3, 1e-4, 5e-4)}


@pytest.fixture(scope="module", params=sorted(_BACKBONES))
def jax_trainer(request, tmp_path_factory):
    llm, quant, *tol = _BACKBONES[request.param]
    cfg = _cfg(tmp_path_factory.mktemp("logs"), llm, quant)
    cfg.training.optimizer = "sgd"
    cfg.training.learning_rate = 1e-2
    return cfg, jax_get_trainer("jax", cfg), tol


def _port(cfg, jt):
    tt = get_trainer("port", cfg, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    return tt


@pytest.mark.parametrize("cached", [True, False])
def test_train_steps_match_jax_trainer(jax_trainer, cached):
    """(h) three SGD train steps on the same shuffled batches: the loss of
    each step and every trainable parameter after it against the JAX
    trainer's train_step; the backbone does not move."""
    cfg, jt, (loss_rtol, rtol, atol) = jax_trainer
    tt = _port(cfg, jt)
    params = jax.tree.map(jnp.array, jt.params)  # jt's own stay untouched
    state = jt.optimizer.init(params)
    backbone = {k: v.clone() for k, v in tt.model.state_dict().items()
                if k.startswith("llm.")}
    jpipe = JaxBatchPipeline(jt.train_dataset, cfg.training.batch_size, shuffle=True,
                             seed=cfg.setup.seed)
    for step, (jb, tb) in enumerate(zip(jpipe, tt.train_pipeline)):
        if step == 3:
            break
        np.testing.assert_array_equal(jb["index"], tb["index"])
        if cached:
            ja, ta = jt.train_model_inputs(jb), tt.train_model_inputs(tb)
            assert "prefix_kv" in ja and "prefix_kv" in ta
        else:
            ja, ta = jt.model_inputs(jb), tt._to_device(tt.model_inputs(tb))
            assert "prefix_ids" in ja and "prefix_ids" in ta
        params, state, loss_j = jt.train_step(params, state, ja, jnp.asarray(jb["valid"]),
                                              jax.random.PRNGKey(step))
        loss_t = tt.train_step(ta, ta["valid"])
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=loss_rtol)
        want = from_flax(jax.device_get(params))
        got = tt.model.state_dict()
        trained = [k for k in got if not k.startswith("llm.")]
        assert trained
        for k in trained:
            np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=rtol, atol=atol,
                                       err_msg=f"step {step}: {k}")
    for k, v in backbone.items():
        assert torch.equal(tt.model.state_dict()[k], v), k
    assert not tt.model.training


# --------------------------------------------------------------------------
# (i) cached = uncached in training, (j) dropout
# --------------------------------------------------------------------------

def _loss_and_grads(tt, arrays, seed):
    tt.model.train()
    tt.model.zero_grad(set_to_none=True)
    gen = torch.Generator().manual_seed(seed)
    pred = tt.model(arrays, generator=gen).float()
    loss = tt.loss_fn(pred, arrays, arrays["valid"])
    loss.backward()
    tt.model.eval()
    return float(loss.detach()), {n: p.grad.clone() for n, p in tt.model.named_parameters()
                         if p.requires_grad}


@pytest.mark.parametrize("llm", ["llama-tiny", "mamba-tiny"])
def test_cached_train_gradients_equal_uncached(tmp_path, llm):
    """(i) with dropout 0.1 and the same masks: the loss (rtol 1e-5) and the
    gradient of every trainable parameter (rtol 1e-4, atol 1e-5 of the
    largest) with the prompt head served from the cache equal those with
    the head embedded in the graph (tests/test_prefix_cache.py)."""
    tt = get_trainer("port", _cfg(tmp_path, llm, False, dropout=0.1), device="cpu")
    assert tt.model.train_prefix_cache_safe
    batch = next(iter(tt.train_pipeline))
    emb = tt._to_device(tt.model_inputs(batch))
    kv = tt.train_model_inputs(batch)
    assert "prefix_kv" in kv and "prefix_ids" not in kv and "prefix_ids" in emb
    l1, g1 = _loss_and_grads(tt, emb, 7)
    l2, g2 = _loss_and_grads(tt, kv, 7)
    np.testing.assert_allclose(l1, l2, rtol=1e-5)
    assert set(g1) == set(g2) and not any(k.startswith("llm.") for k in g1)
    assert {k.split(".")[0] for k in g1} == {
        "patch_embedding", "mapping_layer", "reprogramming_layer", "output_projection",
        "embedding_downsample_layer"}
    for k in g1:
        _close(g2[k], g1[k], 1e-4, 1e-5)


def test_dropout_train_only_and_from_the_trainers_generator(tmp_path):
    """(j) dropout acts in train mode only; its masks come from the
    trainer's generator, seeded from setup.seed: two trainers of one config
    take the same first step, a reseeded generator another; PyTorch's global
    generator is not drawn from."""
    cfg = _cfg(tmp_path, "llama-tiny", False, dropout=0.1)
    a, b = (get_trainer(n, cfg, device="cpu") for n in ("a", "b"))
    no_drop = get_trainer("c", _cfg(tmp_path, "llama-tiny", False), device="cpu")
    no_drop.load_state_dict(a.model.state_dict())
    batch = next(iter(BatchPipeline(a.train_dataset, 4)))
    arrays = a.train_model_inputs(batch)
    np.testing.assert_array_equal(a.eval_step(arrays).numpy(),
                                  no_drop.eval_step(arrays).numpy())
    l_plain = _loss_and_grads(no_drop, arrays, 0)[0]
    assert _loss_and_grads(a, arrays, 0)[0] != l_plain
    assert _loss_and_grads(a, arrays, 0)[0] == _loss_and_grads(a, arrays, 0)[0]
    global_state = torch.get_rng_state()
    gen_state = a.dropout_generator.get_state()
    la, lb = a.train_step(arrays, arrays["valid"]), b.train_step(arrays, arrays["valid"])
    assert float(la) == float(lb)
    assert not torch.equal(a.dropout_generator.get_state(), gen_state)
    assert torch.equal(torch.get_rng_state(), global_state)
    c = get_trainer("d", cfg, device="cpu")
    c.dropout_generator.manual_seed(cfg.setup.seed + 1)
    assert float(c.train_step(arrays, arrays["valid"])) != float(la)


def test_train_loop_runs_epochs_and_val(tmp_path):
    """train(): each epoch runs every shuffled train batch, keeps each loss,
    then scores the val split; the fusion layers move, the backbone does
    not; val() and test() scores are finite."""
    cfg = _cfg(tmp_path, "mamba-tiny", False, dropout=0.1)
    cfg.training.epochs = 2
    cfg.training.lr_scheduler = "cosine"
    tt = get_trainer("port", cfg, device="cpu")
    before = {k: v.clone() for k, v in tt.model.state_dict().items()}
    tt.train()
    n = len(tt.train_pipeline)
    assert len(tt.losses) == 2 * n and all(np.isfinite(tt.losses))
    assert tt.epoch == 3 and tt.step == 2 * len(tt.train_dataset)
    assert tt.optimizer.get_last_lr() == [pytest.approx(0.0)]  # cosine's end (min 0)
    after = tt.model.state_dict()
    moved = {k.split(".")[0] for k in after if not torch.equal(after[k], before[k])}
    assert moved == {"patch_embedding", "mapping_layer", "reprogramming_layer",
                     "output_projection", "embedding_downsample_layer"}
    scores = tt.val()
    assert set(scores) == {"val/mse", "val/mae"} and tt.best_score <= scores["val/mse"]
    assert all(np.isfinite(v) for v in (*scores.values(), *tt.test().values()))


def test_unported_training_options_raise(tmp_path):
    # ``llm.int8_backward`` is ported: every projection takes the int8 dx
    # (tests/test_torch_quant_train.py holds it to JAX's bit for bit), and
    # JAX's own ValueError stays where the s8 path does not run
    cfg = _cfg(tmp_path, "llama-tiny", True)
    cfg.models.medtsllm.llm.int8_backward = True
    tt = get_trainer("x", cfg, device="cpu")
    assert {m.act_quant for m in tt.model.llm.modules()
            if isinstance(m, QuantLinear)} == {"int8_bwd"}
    cfg = _cfg(tmp_path, "llama-tiny", False)
    cfg.models.medtsllm.llm.int8_backward = True
    with pytest.raises(ValueError, match="int8_backward requires the s8 MXU matmul path"):
        get_trainer("x", cfg, device="cpu")
    # "mixed" is ported: the w8a8 finetune builds with a bf16 backbone
    # (int8 weights, bf16 scales) and f32 fusion layers
    cfg = _cfg(tmp_path, "llama-tiny", True)
    cfg.setup.dtype = "mixed"
    tt = get_trainer("x", cfg, device="cpu")
    assert tt.model.llm.blocks[0].attn.q_proj.scale.dtype == torch.bfloat16
    assert tt.model.mapping_layer.weight.dtype == torch.float32
