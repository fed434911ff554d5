"""The port's serving loop and its captured step, on the CPU.

  1. ``data.prefetch``: the plain iterator's order; a producer exception
     re-raised in the consumer; the producer thread gone after the consumer
     stops early (close, or the generator dropped).
  2. ``run_eval`` with the prefetch thread and the one-deep readback on
     llama-tiny (dense f32) and mamba-tiny (f32): bit-equal to the loop it
     replaced (each batch read back before the next), and within 1e-5 of
     JAX's ``run_eval`` on copied weights (the slice tests' f32 tolerance).
  3. The prompt-head cache refilled in place: the same tensors after a
     second pass and after ``load_state_dict``, holding the new prefill.
  4. The graph module's pure parts: ``step_key``, the launch-counter
     bookkeeping on fake wrappers, the registry covering every kernel
     counter, and a CPU device refused (the CPU runs the eager step).
  5. The nf4 / fp4 table made once per device, bit-equal to ``CODEBOOKS``
     and to the JAX package's tables.

Every wait on another thread is bounded, so a fault fails the test instead
of hanging the run.
"""

import importlib
import sys
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from conftest import make_config
from medtsllm_tpu.models.llm.transformer import QUANT4_CODEBOOKS
from medtsllm_tpu.tasks import get_trainer as jax_get_trainer
from medtsllm_tpu_torch import data
from medtsllm_tpu_torch.ops.kernels import w4a8
from medtsllm_tpu_torch.runtime import graph
from medtsllm_tpu_torch.tasks import base, get_trainer
from medtsllm_tpu_torch.weights import from_flax

torch.set_num_threads(1)

WAIT_S = 20.0


def _in_thread(fn):
    """fn() in a daemon thread, its result or exception within WAIT_S."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - handed to the test
            box["error"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=WAIT_S)
    assert not t.is_alive(), f"no result within {WAIT_S} s"
    if "error" in box:
        raise box["error"]
    return box["value"]


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "medtsllm-prefetch"]


def _wait_no_prefetch_thread():
    deadline = time.monotonic() + WAIT_S
    while _prefetch_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not _prefetch_threads(), "the prefetch thread outlived its consumer"


# --------------------------------------------------------------------------
# 1. prefetch
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,size", [(0, 2), (1, 1), (17, 2), (50, 4)])
def test_prefetch_keeps_order(n, size):
    assert _in_thread(lambda: list(data.prefetch(iter(range(n)), size))) == list(range(n))
    _wait_no_prefetch_thread()


def test_prefetch_order_under_fast_thread_switching():
    """Producer and consumer switched every few microseconds over many items
    through a one-slot queue: none lost, none reordered."""
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = _in_thread(lambda: list(data.prefetch(iter(range(5000)), size=1)))
    finally:
        sys.setswitchinterval(prev)
    assert got == list(range(5000))
    _wait_no_prefetch_thread()


def test_prefetch_batches_equal_the_pipeline():
    cfg = make_config(task="reconstruction", model="medtsllm", hist=32, pred=32, step=16)
    ds = data.SyntheticDataset(cfg, "test")
    pipe = data.BatchPipeline(ds, 4)
    got = _in_thread(lambda: list(data.prefetch(iter(pipe))))
    want = list(pipe)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_prefetch_reraises_producer_error():
    def source():
        yield from range(3)
        raise ValueError("producer died")

    seen = []

    def consume():
        for item in data.prefetch(source()):
            seen.append(item)
    with pytest.raises(ValueError, match="producer died"):
        _in_thread(consume)
    assert seen == [0, 1, 2]
    _wait_no_prefetch_thread()


@pytest.mark.parametrize("how", ["close", "drop"])
def test_prefetch_stops_after_early_exit(how):
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    def take_two():
        gen = data.prefetch(endless(), size=2)
        items = [next(gen), next(gen)]
        if how == "close":
            gen.close()
        else:
            del gen  # the generator's finalizer closes it
        return items
    assert _in_thread(take_two) == [0, 1]
    _wait_no_prefetch_thread()
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) == n <= 2 + 2 + 1  # taken, queued, one in hand


# --------------------------------------------------------------------------
# 2-3. run_eval and the prefix cache on two tiny slices
# --------------------------------------------------------------------------

def _cfg(tmp_path, llm):
    """tests/test_torch_medtsllm.py's / test_torch_mamba.py's serving config,
    dense f32."""
    cfg = make_config(task="reconstruction", model="medtsllm", hist=32, pred=32,
                      step=16)
    cfg["paths"] = {"logdir": str(tmp_path / "logs")}
    cfg.training.batch_size = 4
    cfg.datasets.synthetic.n_points = 384
    cfg.setup.dtype = "float32"
    cfg["models"] = {"medtsllm": {
        "d_model": 16, "d_ff": 16, "n_heads": 4, "num_tokens": 32,
        "covariate_mode": "concat", "embedding_downsample_mode": "linear",
        "patching": {"patch_len": 8, "stride": 4},
        "prompting": {"dataset": True, "task": True, "clip": False,
                      "input_stats": True, "examples": False,
                      "input_stats_dim": 0, "input_stats_select": "all",
                      "cache_order": llm == "llama-tiny"},
        "llm": {"enabled": True, "llm": llm, "llm_layers": -1,
                "prefix_cache": True, "load_in_4bit": False,
                "load_in_8bit": False},
    }}
    return cfg


@pytest.fixture(scope="module", params=["llama-tiny", "mamba-tiny"])
def pair(request, tmp_path_factory):
    cfg = _cfg(tmp_path_factory.mktemp("logs"), request.param)
    jt = jax_get_trainer("jax", cfg)
    tt = get_trainer("port", cfg, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    return jt, tt


def _old_run_eval(tt, pipeline, extra_keys):
    """The loop run_eval replaced: each batch read back before the next is
    dispatched, no prefetch thread."""
    tt._prefix_kv_cache.clear()
    preds, extras = [], {k: [] for k in extra_keys}
    for batch in pipeline:
        out = tt.eval_dispatch(batch)
        v = batch["valid"]
        preds.append(out.float().cpu().numpy()[v])
        for k in extra_keys:
            extras[k].append(np.asarray(batch[k])[v])
    result = {"pred": np.concatenate(preds)}
    for k in extra_keys:
        result[k] = np.concatenate(extras[k])
    return result


def test_run_eval_matches_the_old_loop_and_jax(pair):
    jt, tt = pair
    keys = ("x_enc", "index")
    got = tt.run_eval(tt.test_pipeline, extra_keys=keys)
    old = _old_run_eval(tt, tt.test_pipeline, keys)
    assert got.keys() == old.keys()
    for k in old:
        np.testing.assert_array_equal(got[k], old[k])
    want = jt.run_eval(jt.test_pipeline, extra_keys=keys)
    np.testing.assert_array_equal(got["index"], np.asarray(want["index"]))
    np.testing.assert_array_equal(got["x_enc"], np.asarray(want["x_enc"]))
    w = np.asarray(want["pred"])
    np.testing.assert_allclose(got["pred"], w, rtol=1e-5, atol=1e-5 * np.abs(w).max())
    _wait_no_prefetch_thread()


def test_loops_take_batches_from_prefetch(pair, monkeypatch):
    """train() and run_eval() (in val() and test()) iterate the port's
    prefetch over their pipelines."""
    _, tt = pair
    calls = []

    def spy(iterator, size=2):
        calls.append(iterator)
        return data.prefetch(iterator, size)
    monkeypatch.setattr(base, "prefetch", spy)
    fresh = get_trainer("port-train", tt.config, device="cpu")
    _in_thread(fresh.train)
    assert len(calls) == 2 and len(fresh.losses) == len(fresh.train_pipeline)
    fresh.test()
    assert len(calls) == 3
    _wait_no_prefetch_thread()


def test_prefix_cache_refills_in_place(pair):
    """A second pass and new weights refill the head's tensors in place,
    with the values a fresh prefill gives."""
    _, tt = pair
    tt.test()
    (key, kv), = tt._prefix_kv_store.items()
    ptrs = [t.data_ptr() for layer in kv for t in layer]
    tt.test()
    assert tt._prefix_kv_cache[key] is kv
    state = tt.model.state_dict()
    g = torch.Generator().manual_seed(1)
    new = {k: v + 0.01 * torch.randn(v.shape, generator=g) if v.is_floating_point() else v
           for k, v in state.items()}
    tt.load_state_dict(new)
    try:
        assert not tt._prefix_kv_cache
        batch = next(iter(tt.test_pipeline))
        again = tt.eval_model_inputs(batch)["prefix_kv"]
        assert again is kv and [t.data_ptr() for layer in kv for t in layer] == ptrs
        ids = tt.model_inputs(batch)["prefix_ids"]
        with torch.no_grad():
            fresh = tt.model.prefill(torch.as_tensor(ids), torch.float32)
        for layer, want in zip(kv, fresh):
            for t, w in zip(layer, want):
                assert torch.equal(t, w)
    finally:
        tt.load_state_dict(state)


# --------------------------------------------------------------------------
# 4. the graph module's pure parts
# --------------------------------------------------------------------------

def test_step_key_is_the_input_signature():
    x = torch.zeros(4, 32, 3)
    ids = torch.zeros(4, 16, dtype=torch.int64)
    kv = ((torch.zeros(1, 2, 5, 16), torch.zeros(1, 2, 5, 16)),)
    key = graph.step_key({"x_enc": x, "prompt_ids": ids, "prefix_kv": kv})
    # the same shapes (other values, other tensors) and the same prefix tensors
    assert key == graph.step_key({"prompt_ids": ids.clone() + 3, "x_enc": x + 1,
                                  "prefix_kv": kv})
    other_bucket = {"x_enc": x, "prompt_ids": torch.zeros(4, 32, dtype=torch.int64),
                    "prefix_kv": kv}
    other_dtype = {"x_enc": x.double(), "prompt_ids": ids, "prefix_kv": kv}
    moved_prefix = {"x_enc": x, "prompt_ids": ids,
                    "prefix_kv": tuple(tuple(t.clone() for t in layer) for layer in kv)}
    no_prefix = {"x_enc": x, "prompt_ids": ids}
    keys = [graph.step_key(a) for a in (other_bucket, other_dtype, moved_prefix, no_prefix)]
    assert len({key, *keys}) == 5


def test_launch_counter_bookkeeping():
    fake = {"a": SimpleNamespace(launches=3), "b": SimpleNamespace(launches=0),
            "c": SimpleNamespace(launches=7)}
    before = graph.read_counts(fake)
    fake["a"].launches += 2
    fake["c"].launches += 24
    delta = graph.count_delta(before, graph.read_counts(fake))
    assert delta == {"a": 2, "c": 24}
    for name, n in before.items():  # what a capture does after reading
        fake[name].launches = n
    for _ in range(3):  # three replays
        graph.add_counts(fake, delta)
    assert graph.read_counts(fake) == {"a": 9, "b": 0, "c": 79}


def test_launch_counters_cover_every_kernel_wrapper():
    registered = {id(c) for c in graph.launch_counters().values()}
    names = ("flash_attention", "grouped_matmul", "reprogramming", "rope_attention",
             "selective_scan", "w4a8", "w8a8")
    found = set()
    for name in names:
        mod = importlib.import_module(f"medtsllm_tpu_torch.ops.kernels.{name}")
        for attr, obj in vars(mod).items():
            if not isinstance(obj, type) and isinstance(getattr(obj, "launches", None), int):
                found.add(id(obj))
                assert id(obj) in registered, f"{name}.{attr} is not in launch_counters()"
    assert found == registered


def test_cpu_runs_the_eager_step(pair):
    _, tt = pair
    assert tt.step_graphs is None
    with pytest.raises(ValueError, match="CUDA graphs"):
        graph.StepGraphs(tt.model, torch.device("cpu"))
    batch = next(iter(tt.test_pipeline))
    arrays = tt.eval_model_inputs(batch)
    assert torch.equal(tt.eval_step(arrays), tt.eval_step_eager(arrays))


# --------------------------------------------------------------------------
# 5. the codebook tables
# --------------------------------------------------------------------------

@pytest.mark.parametrize("codebook", ["nf4", "fp4"])
def test_codebook_table_made_once_and_bit_equal(codebook):
    cpu = torch.device("cpu")
    table = w4a8.codebook_table(codebook, cpu)
    assert w4a8.codebook_table(codebook, cpu) is table
    assert table.dtype == torch.float32 and not table.is_inference()
    assert torch.equal(table, torch.tensor(w4a8.CODEBOOKS[codebook], dtype=torch.float32))
    np.testing.assert_array_equal(table.numpy(),
                                  np.asarray(QUANT4_CODEBOOKS[codebook], dtype=np.float32))
    packed = torch.randint(-128, 128, (5, 7), dtype=torch.int8,
                           generator=torch.Generator().manual_seed(0))
    codes = w4a8.unpack4_split(packed, 13).long() + 8
    assert torch.equal(w4a8.dequant_codebook(packed, 13, codebook), table[codes])
