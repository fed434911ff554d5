"""The port's run lifecycle against the JAX package's, on the CPU:

  (a) the config helpers on every shipped config: ``dumps_toml`` byte-equal
      to JAX's and read back by ``tomllib`` to the file's dict;
      ``summarize_config``, ``flatten_dict`` and ``get_logging_tags`` equal
      to JAX's; ``Config.copy`` / ``merge``; ``get_run_id``;
  (b) the checkpoint file: the round trip bit-equal in f32 and at the
      storage dtypes of ``mixed``; async saves to one path landing
      last-submitted-wins; a sync save after a failed async one, whose
      error surfaces at ``wait_for_saves``; ``restore_partial``'s three
      rules; a checkpoint written by the JAX package refused;
  (c) a trainer's checkpoint on ``from_flax`` weights: exactly the names
      and the values of ``from_flax(JAX checkpoint_params())``, in f32 and
      ``mixed``;
  (d) train then test, ``from_run_id`` and test again (scores equal, the
      whole state dict bit-equal, ``epoch`` / ``step`` as JAX's flow);
      resume with one more epoch; SIGUSR1 in a train subprocess; the run
      directory under the debug, tensorboard and print loggers, tensorboard
      missing, the task figures; both CLIs' ``main`` on the CPU.

Sizes: llama-tiny, two layers, history 32, batch 4 (tests/test_torch_pretraining.py's)."""

import glob
import json
import os
import re
import signal
import subprocess
import sys
import tomllib
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import make_config
from medtsllm_tpu import config as jax_config
from medtsllm_tpu import utils as jax_utils
from medtsllm_tpu.runtime import checkpoint as jax_checkpoint
from test_torch_baseline_tasks import jax_get_trainer_jitted as jax_get_trainer
from medtsllm_tpu_torch import config as port_config
from medtsllm_tpu_torch import test as test_cli
from medtsllm_tpu_torch import train as train_cli
from medtsllm_tpu_torch import utils as port_utils
from medtsllm_tpu_torch.runtime import checkpoint as ckpt
from medtsllm_tpu_torch.tasks import get_trainer, task_lookup
from medtsllm_tpu_torch.weights import from_flax

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SHIPPED = sorted(str(Path(p).relative_to(ROOT))
                 for p in glob.glob(str(ROOT / "configs" / "**" / "*.toml"), recursive=True))


def _cfg(logdir, dtype="float32", logger="print", epochs=1, n_points=200):
    cfg = make_config(task="reconstruction", model="medtsllm", hist=32, pred=32, step=16)
    cfg["paths"] = {"logdir": str(logdir)}
    cfg.setup.dtype, cfg.setup.logger = dtype, logger
    cfg.training.batch_size, cfg.training.epochs = 4, epochs
    cfg.training.optimizer, cfg.training.learning_rate = "sgd", 1e-2
    cfg.datasets.synthetic.n_points = n_points
    cfg["models"] = {"medtsllm": {
        "d_model": 16, "d_ff": 16, "n_heads": 4, "num_tokens": 32,
        "covariate_mode": "concat", "embedding_downsample_mode": "linear",
        "patching": {"patch_len": 8, "stride": 4},
        "prompting": {"dataset": True, "task": True, "clip": False, "input_stats": True,
                      "examples": False, "input_stats_dim": 0,
                      "input_stats_select": "all"},
        "llm": {"enabled": True, "llm": "llama-tiny", "llm_layers": 2, "prefix_cache": True,
                "load_in_4bit": False, "load_in_8bit": False}}}
    return cfg


def _same_state(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)


# --------------------------------------------------------------------------
# (a) the config helpers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("path", SHIPPED)
def test_config_helpers_match_jax(path):
    """Every shipped config: the TOML the run directory gets is JAX's byte
    for byte and reads back to the file's dict; the logger's summaries and
    tags are JAX's."""
    jc, tc = jax_config.load_config(ROOT / path), port_config.load_config(ROOT / path)
    text = port_config.dumps_toml(tc)
    assert text == jax_config.dumps_toml(jc)
    assert tomllib.loads(text) == tomllib.loads((ROOT / path).read_text())
    assert port_config.dumps_toml(tc.to_dict()) == text
    assert port_config.summarize_config(tc).to_dict() == \
        jax_config.summarize_config(jc).to_dict()
    assert port_config.flatten_dict(tc) == jax_config.flatten_dict(jc)
    assert port_config.get_logging_tags(tc) == jax_config.get_logging_tags(jc)


def test_config_copy_merge_and_run_id(tmp_path):
    """``copy`` is deep, ``merge`` deep-merges (JAX's); ``save_config``
    writes ``dumps_toml``; the run id is JAX's timestamp, ``DEBUG-`` in
    front under ``DEBUG``."""
    tc = port_config.load_config(ROOT / "configs" / "datasets" / "bidmc.toml")
    jc = jax_config.load_config(ROOT / "configs" / "datasets" / "bidmc.toml")
    upd = {"training": {"epochs": 3}, "paths": {"logdir": "x"}}
    assert tc.merge(upd).to_dict() == jc.merge(upd).to_dict()
    assert tc.merge(upd).training.batch_size == tc.training.batch_size
    cp = tc.copy()
    assert cp.to_dict() == tc.to_dict()
    cp.training._data["epochs"] = 99  # the copy is deep: the original keeps its value
    assert tc.training.epochs != 99
    assert dict(tc.items()).keys() == tc.to_dict().keys()
    port_config.save_config(tc, tmp_path / "c.toml")
    assert (tmp_path / "c.toml").read_text() == port_config.dumps_toml(tc)
    pattern = r"\d{4}-\d\d-\d\d_\d\d-\d\d-\d\d"
    assert re.fullmatch(pattern, port_utils.get_run_id(tc))
    assert re.fullmatch(pattern, jax_utils.get_run_id(jc))
    debug = port_config.Config({"DEBUG": True})
    assert re.fullmatch("DEBUG-" + pattern, port_utils.get_run_id(debug))


# --------------------------------------------------------------------------
# (b) the checkpoint file
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "mixed"])
@pytest.mark.parametrize("async_", [False, True])
def test_checkpoint_round_trip(tmp_path, dtype, async_):
    """The file holds JAX's header (8-byte length, the JSON meta) and a
    torch.save payload; every tensor comes back bit-equal at its dtype (f32
    trainable and bf16 frozen under mixed; int8 and int64 as they are)."""
    g = torch.Generator().manual_seed(0)
    low = torch.bfloat16 if dtype == "mixed" else torch.float32
    state = {"mapping_layer.weight": torch.randn(8, 5, generator=g),
             "llm.wte": torch.randn(6, 4, generator=g).to(low),
             "llm.blocks.0.attn.weight_q": torch.randint(-127, 128, (4, 4), dtype=torch.int8,
                                                         generator=g),
             "step": torch.tensor([7], dtype=torch.int64)}
    meta = {"run_id": "r", "epoch": 2, "step": 12, "best_score": float("inf"),
            "datetime": "2026-01-01T00:00:00"}
    path = tmp_path / "latest.ckpt"
    ckpt.save_checkpoint(path, state, meta, async_=async_)
    ckpt.wait_for_saves()
    raw = path.read_bytes()
    n = int.from_bytes(raw[:8], "little")
    assert json.loads(raw[8:8 + n]) == meta and raw[8 + n:8 + n + 4] == b"PK\x03\x04"
    got, got_meta = ckpt.load_checkpoint(path)
    assert got_meta == meta and _same_state(got, state)
    assert [p.name for p in tmp_path.iterdir()] == ["latest.ckpt"]  # no temporary left


def test_async_saves_to_one_path_land_last_submitted_wins(tmp_path):
    """The ordered worker: of many async saves to one path the last one
    made is the one on disk; each call copied its tensor when it was made
    (the tensor is changed in place after every call)."""
    w = torch.zeros(2048)
    path = tmp_path / "latest.ckpt"
    for epoch in range(1, 21):
        w.fill_(epoch)
        ckpt.save_checkpoint(path, {"w": w}, {"epoch": epoch}, async_=True)
    w.fill_(-1.0)
    ckpt.wait_for_saves()
    state, meta = ckpt.load_checkpoint(path)
    assert meta["epoch"] == 20 and torch.equal(state["w"], torch.full((2048,), 20.0))


def test_sync_save_survives_stale_async_error(tmp_path):
    """JAX's test of the same name: the preemption save (sync) is not
    aborted by a failed async write; that error surfaces once at the next
    ``wait_for_saves`` and is then cleared."""
    bad = tmp_path / "nodir" / "x.ckpt"  # the directory is missing: the write fails
    ckpt.save_checkpoint(bad, {"w": torch.zeros(2)}, {"epoch": 1}, async_=True)
    ckpt._save_queue.join()
    assert ckpt._save_errors
    good = tmp_path / "latest.ckpt"
    ckpt.save_checkpoint(good, {"w": torch.ones(2)}, {"epoch": 2}, async_=False)
    assert good.exists(), "the sync save was aborted by the stale async error"
    with pytest.raises(RuntimeError, match="checkpoint write"):
        ckpt.wait_for_saves()
    ckpt.wait_for_saves()  # cleared


def test_restore_partial_rules():
    """JAX's three rules on state-dict names: ``skip_prefixes`` match whole
    segments ("llm" skips "llm.k", not "llm_adapter.k"), an unexpected
    name raises KeyError, a shape mismatch ValueError (and neither writes
    anything); the restore copies into the template's tensors in place, at
    their dtype."""
    tmpl = {"llm.k": torch.zeros(2), "llm_adapter.k": torch.zeros(2),
            "head.w": torch.zeros(3, dtype=torch.bfloat16)}
    addr = {k: v.data_ptr() for k, v in tmpl.items()}
    saved = {"llm.k": torch.ones(2), "llm_adapter.k": torch.ones(2),
             "head.w": torch.full((3,), 2.0)}
    merged, loaded = ckpt.restore_partial(tmpl, saved, skip_prefixes=("llm",))
    assert merged is tmpl and loaded == ["llm_adapter.k", "head.w"]
    assert torch.equal(tmpl["llm.k"], torch.zeros(2))
    assert torch.equal(tmpl["llm_adapter.k"], torch.ones(2))
    assert tmpl["head.w"].dtype == torch.bfloat16 and (tmpl["head.w"] == 2).all()
    assert {k: v.data_ptr() for k, v in tmpl.items()} == addr
    with pytest.raises(KeyError, match="Unexpected key in checkpoint: extra.w"):
        ckpt.restore_partial(tmpl, {"llm_adapter.k": torch.full((2,), 5.0),
                                    "extra.w": torch.ones(1)})
    with pytest.raises(ValueError, match="Shape mismatch for head.w"):
        ckpt.restore_partial(tmpl, {"llm_adapter.k": torch.full((2,), 5.0),
                                    "head.w": torch.ones(4)})
    assert torch.equal(tmpl["llm_adapter.k"], torch.ones(2))  # nothing written


def test_jax_checkpoint_is_refused(tmp_path):
    """A checkpoint written by the JAX package (the same header, a flax
    msgpack payload) raises an error that says so, and nothing is parsed."""
    path = tmp_path / "latest.ckpt"
    jax_checkpoint.save_checkpoint(path, {"mapping_layer": {"kernel": np.ones((2, 3))}},
                                   {"epoch": 2, "step": 8})
    with pytest.raises(ValueError, match="JAX package"):
        ckpt.load_checkpoint(path)
    junk = tmp_path / "junk.ckpt"
    junk.write_bytes((4).to_bytes(8, "little") + b"\xff\xfe\x00\x01rest")
    with pytest.raises(ValueError, match="not a checkpoint"):
        ckpt.load_checkpoint(junk)


# --------------------------------------------------------------------------
# (c) a trainer's checkpoint against JAX's
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_f32(tmp_path_factory):
    """JAX's trainer of ``_cfg`` in f32, two epochs."""
    cfg = _cfg(tmp_path_factory.mktemp("jax"), epochs=2)
    return cfg, jax_get_trainer("jax", cfg)


@pytest.mark.parametrize("dtype", ["float32", "mixed"])
def test_checkpoint_matches_jax_checkpoint_params(tmp_path, jax_f32, dtype):
    """On the same ``from_flax`` weights, the port's checkpoint (in memory
    and as saved) holds exactly ``from_flax(JAX checkpoint_params())``:
    its names (no ``llm.*``, so the word embeddings neither) and its values
    bit for bit, at their storage dtypes (f32 fusion layers under mixed)."""
    if dtype == "float32":
        _, jt = jax_f32
    else:
        jt = jax_get_trainer("jax", _cfg(tmp_path / "jax", dtype))
    want = from_flax(jax.device_get(jt.checkpoint_params()))
    tt = get_trainer("port", _cfg(tmp_path, dtype), device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    got = tt.checkpoint_params()
    assert sorted(got) == sorted(want) and not any(k.startswith("llm.") for k in got)
    assert _same_state({k: v for k, v in got.items()}, want)
    assert all(v.dtype == torch.float32 for v in got.values())
    tt.logger.save_state("latest", async_=False)
    saved, meta = ckpt.load_checkpoint(tmp_path / "port" / "checkpoints" / "latest.ckpt")
    assert _same_state(saved, want)
    assert meta.keys() == {"run_id", "epoch", "step", "best_score", "datetime"}
    assert (meta["run_id"], meta["epoch"], meta["step"]) == ("port", 1, 0)


# --------------------------------------------------------------------------
# (d) train, test, resume, SIGUSR1, the loggers, the CLIs
# --------------------------------------------------------------------------

def test_train_eval_checkpoint_resume(tmp_path, jax_f32):
    """tests/test_e2e_forecasting.py::test_train_eval_checkpoint_resume
    mirrored: train two epochs, ``test()``, ``log_end``; ``from_run_id``
    rebuilds the run (its backbone from the seed, the rest from ``latest``)
    with every tensor of the state dict bit-equal, the same test scores,
    and ``epoch`` / ``step`` / ``best_score`` of the checkpoint; ``epoch``
    and ``step`` as JAX's trainer has them after the same two epochs."""
    _, jt = jax_f32
    jt.train()
    cfg = _cfg(tmp_path / "logs", epochs=2)
    tt = get_trainer("testrun", cfg, device="cpu")
    tt.train()
    scores = tt.test()
    tt.log_end()
    assert np.isfinite(scores["test/mse"]) and len(tt.losses) == 2 * len(tt.train_pipeline)
    assert (tt.epoch, tt.step) == (jt.epoch, jt.step) == (3, 2 * len(tt.train_dataset))
    restored = task_lookup["reconstruction"].from_run_id(
        "testrun", basepath=str(tmp_path / "logs"), device="cpu")
    assert _same_state(restored.model.state_dict(), tt.model.state_dict())
    assert restored.test() == scores
    assert (restored.epoch, restored.step, restored.best_score) == (
        tt.epoch, tt.step, tt.best_score)
    assert tt.best_score == min(s["val/mse"] for s in tt.val_scores)
    best, meta = ckpt.load_checkpoint(tmp_path / "logs" / "testrun" / "checkpoints" / "best.ckpt")
    assert meta["best_score"] == tt.best_score and set(best) == set(tt.checkpoint_params())


def test_resume_continues_not_restarts(tmp_path):
    """tests/test_e2e_forecasting.py::test_resume_continues_not_restarts
    mirrored: ``from_run_id(cfg={"training": {"epochs": n + 1}})`` keeps
    the rest of [training], resumes at epoch n + 1 with ``best_score``, and
    ``train()`` runs exactly one epoch more; the restored parameters keep
    their addresses (the restore copies in place)."""
    cfg = _cfg(tmp_path / "logs", epochs=1)
    tt = get_trainer("resumerun", cfg, device="cpu")
    tt.train()
    tt.log_end()
    restored = task_lookup["reconstruction"].from_run_id(
        "resumerun", cfg={"training": {"epochs": 2}}, basepath=str(tmp_path / "logs"),
        device="cpu")
    assert restored.epoch == 2 and restored.best_score == tt.best_score
    assert restored.config.training.batch_size == cfg.training.batch_size
    assert restored.config.training.epochs == 2
    addrs = [p.data_ptr() for p in restored.model.parameters()]
    assert _same_state(restored.model.state_dict(), tt.model.state_dict())
    restored.train()
    assert restored.epoch == 3 and len(restored.losses) == len(restored.train_pipeline)
    assert restored.step == 2 * len(restored.train_dataset)
    assert [p.data_ptr() for p in restored.model.parameters()] == addrs
    restored.log_end()
    _, meta = ckpt.load_checkpoint(tmp_path / "logs" / "resumerun" / "checkpoints" /
                                   "latest.ckpt")
    assert meta["epoch"] == 3


def test_sigusr1_saves_latest_and_exits(tmp_path):
    """A train CLI subprocess on the CPU gets SIGUSR1 after its first step
    line: it saves ``latest`` (synchronously, at a step boundary) and exits
    0; the checkpoint's meta is the interrupted epoch (1) with the steps so
    far, and no epoch ended (no ``best``)."""
    cfg = _cfg(tmp_path / "logs", n_points=4000)
    path = tmp_path / "run.toml"
    port_config.save_config(cfg, path)
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "medtsllm_tpu_torch.train", str(path), "sigrun",
         "--device", "cpu"],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(ROOT)},
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("step "):
                proc.send_signal(signal.SIGUSR1)
                break
        rest, _ = proc.communicate(timeout=120)
    finally:
        proc.kill()
    out = "".join(lines) + rest
    assert proc.returncode == 0, out[-2000:]
    assert "Interrupted!" in out and "Test results" not in out
    run = tmp_path / "logs" / "sigrun"
    _, meta = ckpt.load_checkpoint(run / "checkpoints" / "latest.ckpt")
    assert meta["epoch"] == 1 and meta["step"] > 0 and meta["run_id"] == "sigrun"
    assert not (run / "checkpoints" / "best.ckpt").exists()
    assert tomllib.loads((run / "config.toml").read_text()) == cfg.to_dict()


def test_debug_logger_writes_nothing(tmp_path, capsys):
    """Under ``DEBUG`` the trainer prints and writes no run directory, no
    checkpoint, whatever ``setup.logger`` says."""
    cfg = _cfg(tmp_path / "logs", logger="tensorboard")
    cfg["DEBUG"] = True
    tt = get_trainer("debugrun", cfg, device="cpu")
    tt.train()
    tt.log_end()
    assert not (tmp_path / "logs").exists()
    out = capsys.readouterr().out
    assert "Run ID: debugrun" in out and "Done!" in out


def _block_tensorflow(monkeypatch):
    """tensorboard without TensorFlow (its own stub), as the writer needs
    no more and the import is seconds faster."""
    if "tensorflow" not in sys.modules:
        monkeypatch.setitem(sys.modules, "tensorflow", None)


def test_tensorboard_logger_writes_events_and_figures(tmp_path, monkeypatch):
    """The tensorboard logger writes the run directory and its event files
    (scalars, hparams, a figure: drawn since the logger takes figures and
    matplotlib imports) and ``config-updates.{toml,json}`` (updates merged,
    list values taken); the
    print logger takes none, and with matplotlib blocked the tensorboard
    logger's trainer warns and draws none. The scores are the same."""
    _block_tensorflow(monkeypatch)
    cfg = _cfg(tmp_path / "logs", logger="tensorboard")
    tt = get_trainer("tbrun", cfg, device="cpu")
    assert type(tt.logger).__name__ == "TensorboardLogger" and tt.logger.takes_figures
    drawn = []
    tt.log_figure("val/predictions", lambda: drawn.append(1) or _figure())
    # list values (data.cols) are joined for the hparams, as JAX's logger does
    tt.logger.update_config({"data": {"cols": ["HR", "SpO2"]}})
    tt.logger.update_config({"training": {"epochs": 3}})
    tt.train()
    tt.log_end()
    run = tmp_path / "logs" / "tbrun"
    updates = {"data": {"cols": ["HR", "SpO2"]}, "training": {"epochs": 3}}
    assert tomllib.loads((run / "config-updates.toml").read_text()) == updates
    assert json.loads((run / "config-updates.json").read_text()) == updates
    assert (run / "config.toml").exists() and (run / "checkpoints" / "latest.ckpt").exists()
    events = list((run / "tensorboard").rglob("events.out.tfevents.*"))
    assert events and sum(e.stat().st_size for e in events) > 0 and drawn == [1]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.warns(UserWarning, match="matplotlib not installed"):
        tt.log_figure("val/predictions", lambda: drawn.append(2))
    assert drawn == [1]
    pt = get_trainer("printrun", _cfg(tmp_path / "logs"), device="cpu")
    assert not pt.logger.takes_figures
    pt.log_figure("val/predictions", lambda: drawn.append(3))
    assert drawn == [1]


def _figure():
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots()
    ax.plot([0, 1], [1, 0])
    return fig


def test_tensorboard_missing_falls_back_to_print(tmp_path, monkeypatch, capsys):
    """The one departure from JAX: ``setup.logger = "tensorboard"`` with
    tensorboard not importable warns once and logs as the print logger
    does; the run directory and the checkpoints are written all the same.
    wandb missing falls back to tensorboard, and so, here, to print."""
    monkeypatch.setitem(sys.modules, "tensorboard", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    for logger in ("tensorboard", "wandb"):
        run = f"no-{logger}"
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tt = get_trainer(run, _cfg(tmp_path / "logs", logger=logger), device="cpu")
        msgs = [str(w.message) for w in caught if "not installed" in str(w.message)]
        assert sum("tensorboard not installed" in m for m in msgs) == 1, msgs
        assert ("wandb not installed" in " ".join(msgs)) == (logger == "wandb")
        assert type(tt.logger).__name__ == "PrintLogger"
        tt.train()
        tt.log_end()
        assert (tmp_path / "logs" / run / "config.json").exists()
        assert (tmp_path / "logs" / run / "checkpoints" / "latest.ckpt").exists()
    assert "Epoch: 1, step: " in capsys.readouterr().out


def test_clis_train_then_test(tmp_path, capsys):
    """``medtsllm_tpu_torch.train.main`` and ``.test.main`` with
    ``device="cpu"``: the test CLI on the run directory reproduces the
    train CLI's test scores (from ``latest``) and gives the val scores;
    the printed lines are the root CLIs'."""
    cfg = _cfg(tmp_path / "logs")
    path = tmp_path / "run.toml"
    port_config.save_config(cfg, path)
    scores = train_cli.main(str(path), "clirun", device="cpu")
    out = capsys.readouterr().out
    assert f"Test results: {scores}" in out and "Run ID: clirun" in out
    again = test_cli.main("clirun", "test", "latest", str(tmp_path / "logs"), device="cpu")
    assert again == scores
    val = test_cli.main("clirun", "val", None, str(tmp_path / "logs"), device="cpu")
    assert set(val) == {"val/mse", "val/mae"}
    out = capsys.readouterr().out
    assert f"Results: {scores}" in out and "Run ID: clirun" in out
    assert train_cli._split_device(["a.toml", "--device", "cpu", "r"]) == (["a.toml", "r"],
                                                                            "cpu")
    with pytest.raises(ValueError, match="Invalid split"):
        test_cli.main("clirun", "train", None, str(tmp_path / "logs"), device="cpu")
