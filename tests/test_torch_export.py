"""Serving export of the port (``medtsllm_tpu_torch/runtime/export.py``)
against the JAX package's (``medtsllm_tpu/runtime/export.py``,
tests/test_export.py):
  (a) llama-tiny at head dim 64 with the prompt-head cache, f32 and w8a8:
      the files, the manifest's keys (JAX's but ``jax_version``) and values,
      the arrays outside ``prefix_kv``; ``verify_roundtrip`` exactly 0.0;
  (b) the loaded eval step against JAX's loaded eval step on the same batch
      and ``from_flax`` weights: f32 1e-5, w8a8 2e-3 (an int8 rounding
      flip, tests/test_torch_medtsllm.py);
  (c) the graph names the ``medtsllm::`` ops of K1's quantizer and GEMM,
      K2 and K3 (w8a8), and the gated scan (mamba-tiny): the ops a card's
      trace launches;
  (d) mamba-tiny's state cache: exact round trip;
  (e) the per-clip bank: the prefill at [1, P], each row bit-equal to the
      live bank's, exact round trip;
  (f) DLinear uncached: no prefill, exact round trip;
  (g) a fresh interpreter with torch and ``medtsllm_tpu_torch.ops.kernels``
      only runs the artifact bit-equal to the live output;
  (h) the CLI on a run that a one-epoch DLinear ``train()`` wrote.
"""

import dataclasses
import json
import subprocess
import sys
import textwrap
import zipfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from conftest import make_config
from test_torch_families import jitted_flax_init
from medtsllm_tpu.models.llm.loader import PRESETS as JAX_PRESETS
from medtsllm_tpu.runtime.export import export_serving as jax_export_serving
from medtsllm_tpu.runtime.export import load_serving as jax_load_serving
from medtsllm_tpu.tasks import get_trainer as jax_get_trainer
from medtsllm_tpu_torch import export as export_cli
from medtsllm_tpu_torch.models.llm.config import PRESETS
from medtsllm_tpu_torch.runtime.export import (export_serving, load_serving, serve_prefix,
                                                serving_params, verify_roundtrip)
from medtsllm_tpu_torch.tasks import get_trainer
from medtsllm_tpu_torch.tasks.base import eval_forward
from medtsllm_tpu_torch.weights import from_flax

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
LLAMA_D64 = "llama-tiny-export-d64"  # llama-tiny at head dim 64: K2's widths
_TOL = {0: 1e-5, 8: 2e-3}


@pytest.fixture(scope="module", autouse=True)
def d64_preset():
    with pytest.MonkeyPatch.context() as mp:
        over = dict(d_model=128, n_heads=2)
        mp.setitem(JAX_PRESETS, LLAMA_D64, dataclasses.replace(JAX_PRESETS["llama-tiny"],
                                                                **over))
        mp.setitem(PRESETS, LLAMA_D64, dataclasses.replace(PRESETS["llama-tiny"], **over))
        yield


def _cfg(logdir, llm=LLAMA_D64, quant=0, clips=False):
    """tests/test_export.py's flagship config."""
    cfg = make_config(task="reconstruction", model="medtsllm", hist=32, pred=32, step=16)
    cfg["paths"] = {"logdir": str(logdir)}
    cfg.training.epochs = 1
    cfg.training.batch_size = 4
    cfg.datasets.synthetic.n_points = 128
    cfg["models"] = {"medtsllm": {
        "d_model": 16, "d_ff": 16, "n_heads": 4, "num_tokens": 32,
        "covariate_mode": "concat", "embedding_downsample_mode": "linear",
        "patching": {"patch_len": 8, "stride": 4},
        "prompting": {"dataset": True, "task": True, "clip": False,
                      "input_stats": False, "examples": False,
                      "input_stats_dim": 0, "input_stats_select": "all"},
        "llm": {"enabled": True, "llm": llm, "llm_layers": -1, "prefix_cache": True,
                "load_in_4bit": False, "load_in_8bit": quant == 8},
    }}
    if clips:
        cfg.datasets.synthetic["clips"] = True
        cfg.datasets.synthetic["n_clips"] = 3
        p = cfg.models.medtsllm.prompting
        p["clip"] = True
        p["clip_head"] = True
        p["clip_cache_slots"] = 4
    return cfg


def _graph_ops(program) -> set:
    """The ``medtsllm::`` ops a loaded program's graph calls."""
    return {n.target.name().split(".")[0] for n in program.graph.nodes
            if n.op == "call_function" and hasattr(n.target, "name")
            and n.target.name().startswith("medtsllm::")}


@pytest.fixture(scope="module", params=sorted(_TOL))
def llama(request, tmp_path_factory):
    """JAX's and the port's trainers on one config and the same weights,
    each exported once."""
    quant = request.param
    root = tmp_path_factory.mktemp(f"llama{quant}")
    cfg = _cfg(root / "logs", quant=quant)
    with jitted_flax_init():  # the port takes JAX's weights, whatever they are
        jt = jax_get_trainer("jax", cfg)
    tt = get_trainer("port", cfg, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    batch = next(iter(tt.val_pipeline))
    out, jout = root / "port", root / "jax"
    manifest = export_serving(tt, out, batch=batch)
    return dict(quant=quant, jt=jt, tt=tt, batch=batch, out=out, jout=jout,
                manifest=manifest, loaded=load_serving(out),
                jmanifest=jax_export_serving(jt, jout, batch=next(iter(jt.val_pipeline))))


def test_manifest_and_roundtrip(llama):
    """(a) the files, JAX's manifest keys (``torch_version`` in place of
    ``jax_version``) with the same values where both describe the same
    thing; an exact round trip."""
    m, jm, out = llama["manifest"], llama["jmanifest"], llama["out"]
    assert {p.name for p in out.iterdir()} == {"eval_step.pt2", "prefill.pt2",
                                                "manifest.json"}
    assert json.loads((out / "manifest.json").read_text()) == m
    assert set(jm) - {"jax_version"} <= set(m) and "torch_version" in m
    for key in ("model", "task", "batch_size", "prefix_cached", "nr_devices", "mesh"):
        assert m[key] == jm[key], key
    assert m["platforms"] == ["cpu"]
    assert set(m["prefill"]) >= set(jm["prefill"])
    for key in ("prefix_ids_shape", "per_clip"):
        assert m["prefill"][key] == jm["prefill"][key], key
    # the arrays outside the prefix state: names, shapes, and dtypes as JAX
    # records them (canonical: with x64 off an int64 host array is int32)
    arrays = {k: v for k, v in m["arrays"].items() if not k.startswith("prefix_kv")}
    jarrays = {k: v for k, v in jm["arrays"].items() if not k.startswith("prefix_kv")}
    assert arrays.keys() == jarrays.keys()
    for k, (shape, dtype) in arrays.items():
        assert shape == jarrays[k][0], k
        assert str(jax.dtypes.canonicalize_dtype(np.dtype(dtype))) == jarrays[k][1], k
    # the params are every tensor of the model; the program holds none
    assert m["params"] == {k: [list(t.shape), str(t.dtype).removeprefix("torch."),
                               t.requires_grad]
                           for k, t in llama["tt"].model.state_dict(keep_vars=True).items()}
    assert m["constants"]["bytes"] < 1024
    for name in ("eval_step.pt2", "prefill.pt2"):  # no weights, no sample inputs
        members = {i.filename.split("/", 1)[1]: i.file_size
                   for i in zipfile.ZipFile(out / name).infolist()}
        data = {k: n for k, n in members.items() if k.startswith("data/")}
        assert any("sample_inputs" in k for k in data) and max(data.values()) < 64, data
    assert m["kernel_library"].startswith("libmedtsllm_kernels_")
    assert verify_roundtrip(llama["tt"], out, batch=llama["batch"]) == 0.0


def test_loaded_matches_jax(llama):
    """(b) the port's loaded program against JAX's loaded program, each
    with its own loaded prefill, on the same batch and weights."""
    tt, jt, batch = llama["tt"], llama["jt"], llama["batch"]
    loaded, jloaded = llama["loaded"], jax_load_serving(llama["jout"])
    arrays = dict(tt.eval_model_inputs(batch))
    params = serving_params(tt.model)
    ids = tt.model_inputs(batch)["prefix_ids"]
    arrays["prefix_kv"] = serve_prefix(loaded, params, ids, tt.device)
    with torch.no_grad():
        got = loaded["eval_step"](params, arrays).float().numpy()
    jarrays = dict(jt.model_inputs(next(iter(jt.val_pipeline))))
    jids = jarrays.pop("prefix_ids")
    np.testing.assert_array_equal(jids, ids)
    jarrays["prefix_kv"] = jloaded["prefill"](jt.params, jids)
    want = np.asarray(jloaded["eval_step"](jt.params, jarrays))
    tol = _TOL[llama["quant"]]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


class _Kernels(TorchDispatchMode):
    """The ops that reach the kernels' dispatch, in order (the export's
    metadata checks and detaches left out)."""

    SKIP = ("aten._assert_tensor_metadata.default", "aten.detach.default",
            "aten.alias.default")

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func) not in self.SKIP:
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_loaded_program_dispatches_the_eager_kernels(llama):
    """The loaded step runs the kernels the eager step runs, op for op: a
    card's bits follow the kernels chosen (``aten.linear`` folds the
    downsample's strided input into one GEMM because its weight requires
    grad; a batched GEMM otherwise), which the CPU's bits cannot show."""
    tt = llama["tt"]
    live = tt.eval_model_inputs(llama["batch"])
    params = serving_params(tt.model)
    with torch.no_grad():
        with _Kernels() as eager:
            eval_forward(tt.model, live)
        with _Kernels() as loaded:
            llama["loaded"]["eval_step"](params, live)
    assert loaded.ops == eager.ops
    assert "aten.bmm.default" not in eager.ops and "aten.mm.default" in eager.ops


def test_graph_names_the_kernels(llama):
    """(c) K2 and K3 in the eval step, K1's quantizer and GEMM at w8a8, as
    the manifest lists them; the prefill runs K2 on the head."""
    want = {"medtsllm::rope_attention", "medtsllm::reprogramming_attention"}
    if llama["quant"]:
        want |= {"medtsllm::quantize_rows", "medtsllm::w8a8_gemm"}
    ops = _graph_ops(llama["loaded"]["eval_step"])
    assert ops == want == set(llama["manifest"]["custom_ops"])
    assert "medtsllm::rope_attention" in _graph_ops(llama["loaded"]["prefill"])


def test_mamba_state_cache(tmp_path):
    """(d) the (conv tail, SSM state) prefix cache, and (c) the gated scan in
    both programs."""
    tt = get_trainer("mamba", _cfg(tmp_path / "logs", llm="mamba-tiny"), device="cpu")
    batch = next(iter(tt.val_pipeline))
    manifest = export_serving(tt, tmp_path / "art", batch=batch)
    assert manifest["prefix_cached"] and not manifest["prefill"]["per_clip"]
    loaded = load_serving(tmp_path / "art")
    for name in ("eval_step", "prefill"):
        assert "medtsllm::selective_ssm_gated" in _graph_ops(loaded[name])
    assert verify_roundtrip(tt, tmp_path / "art", batch=batch) == 0.0


def test_clip_bank_serving(tmp_path):
    """(e) per-clip head rows: the prefill exported at row shape [1, P], the
    bank's convention in the manifest, each exported row bit-equal to the
    live bank's row, an exact round trip."""
    tt = get_trainer("clips", _cfg(tmp_path / "logs", clips=True), device="cpu")
    batch = next(iter(tt.val_pipeline))
    ids = tt.model_inputs(batch)["prefix_ids"]
    assert ids.ndim == 2, "the fixture must exercise the per-clip 2-D head"
    manifest = export_serving(tt, tmp_path / "art", batch=batch)
    assert manifest["prefix_cached"] and manifest["prefill"]["per_clip"]
    assert manifest["prefill"]["prefix_ids_shape"] == [1, ids.shape[1]]
    assert "bank" in manifest["prefill"]["calling_convention"]
    assert verify_roundtrip(tt, tmp_path / "art", batch=batch) == 0.0
    loaded = load_serving(tmp_path / "art")
    params = serving_params(tt.model)
    live = tt.eval_model_inputs(batch)["prefix_kv"]
    for b in range(ids.shape[0]):
        row = loaded["prefill"](params, torch.as_tensor(ids[b:b + 1]))
        for got_layer, want_layer in zip(row, live):
            for got, want in zip(got_layer, want_layer):
                assert torch.equal(got, want[b:b + 1])


@pytest.fixture(scope="module")
def dlinear_run(tmp_path_factory):
    """A run directory that a one-epoch DLinear ``train()`` wrote."""
    root = tmp_path_factory.mktemp("dlinear")
    cfg = make_config(task="forecasting", model="dlinear", hist=32, pred=16, step=16)
    cfg["paths"] = {"logdir": str(root / "logs")}
    cfg.training.epochs = 1
    cfg.training.batch_size = 4
    cfg["models"] = {"dlinear": {"moving_avg": 5, "individual": False}}
    tt = get_trainer("dlin", cfg, device="cpu")
    tt.train()
    tt.log_end()
    return root, tt


def test_baseline_model_uncached(dlinear_run):
    """(f) a prompt-free model exports a single program."""
    root, tt = dlinear_run
    batch = next(iter(tt.val_pipeline))
    manifest = export_serving(tt, root / "art", batch=batch)
    assert not manifest["prefix_cached"] and "prefill" not in manifest
    assert not (root / "art" / "prefill.pt2").exists()
    assert manifest["custom_ops"] == []
    assert verify_roundtrip(tt, root / "art", batch=batch) == 0.0


@pytest.mark.parametrize("llama", [8], indirect=True)
def test_loads_without_the_model_code(llama, tmp_path):
    """(g) a fresh interpreter imports torch and the kernels' package only,
    loads the programs and serves the saved params and host arrays; the
    output equals the live trainer's bit for bit, with no model, task or
    jax module loaded (the w8a8 program: every op kind of the eval step)."""
    tt, batch, out = llama["tt"], llama["batch"], llama["out"]
    live = tt.eval_model_inputs(batch)
    host = {k: v for k, v in live.items() if k != "prefix_kv"}
    torch.save({"params": serving_params(tt.model), "arrays": host,
                "ids": torch.as_tensor(tt.model_inputs(batch)["prefix_ids"]),
                "want": tt.eval_step(live)}, tmp_path / "inputs.pt")
    script = textwrap.dedent(f"""
        import sys
        import torch
        import medtsllm_tpu_torch.ops.kernels
        d = torch.load({str(tmp_path / "inputs.pt")!r})
        prefill = torch.export.load({str(out / "prefill.pt2")!r}).module()
        step = torch.export.load({str(out / "eval_step.pt2")!r}).module()
        with torch.no_grad():
            arrays = dict(d["arrays"], prefix_kv=prefill(d["params"], d["ids"]))
            got = step(d["params"], arrays)
        assert torch.equal(got, d["want"]), (got - d["want"]).abs().max()
        bad = [m for m in sys.modules if m.startswith(("medtsllm_tpu_torch.models",
               "medtsllm_tpu_torch.tasks", "medtsllm_tpu.", "jax", "flax"))
               or m == "medtsllm_tpu"]
        assert not bad, bad
        print("OK")
    """)
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "OK", res.stderr[-3000:]


def test_cli(dlinear_run, capsys):
    """(h) ``python -m medtsllm_tpu_torch.export <run_id> ... --device cpu``'s
    main on the trained run: the checkpoint rebuilt, the artifact written
    under the run, the round trip printed as 0.0."""
    root, _ = dlinear_run
    manifest = export_cli.main("dlin", None, "latest", str(root / "logs"), device="cpu")
    printed = capsys.readouterr().out
    assert "Round-trip max |diff| on one batch: 0.0" in printed
    assert manifest["model"] == "dlinear" and not manifest["prefix_cached"]
    assert {p.name for p in (root / "logs" / "dlin" / "export").iterdir()} == {
        "eval_step.pt2", "manifest.json"}
