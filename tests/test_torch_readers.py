"""The port's dataset families (``medtsllm_tpu_torch/data``, read without
pandas) against the JAX package's ``get_dataset``, on the CPU:

  (a) each family's file format, on miniature files this test writes in
      the formats of tests/test_real_readers.py and
      test_loggers_and_dreams.py::test_dreams_real, with the traps of
      pandas' reading: columns that ``difference`` sorts (bidmc, ECG,
      dreams' "all"), that ``drop`` and ``usecols`` keep in file order (ECG
      reconstruction, PSM, ventilator's pooled files), ETT's date index,
      LUDB's leads in order of appearance and rows sorted by (clip, time),
      integer-keyed description files, missing values (PSM), labels below 0
      dropped (ventilator): every split's labels, clip ids, timestamps,
      clip descriptions, window starts and items exactly equal, and
      ``data`` bit-equal after the float32 cast. pandas' default float
      parser is not correctly rounded: on these files it lands up to
      thousands of float64 ulps (under 1e-12 relative) from the value
      ``float()`` gives, which is pandas' own ``float_precision=
      "round_trip"``. The port's parsed columns equal the round-trip parse
      exactly and lie within 1e-12 relative of the default one (the test
      shows values that differ); the normalised float32 data are bit-equal
      all the same;
  (b) every family's stand-in, for each supported task and split, bit-equal
      to JAX's (``get_dataset`` in the multivariate and univariate views);
      ``data.allow_synthetic = false`` raising where the files are absent;
  (c) ``Multi2UniDataset`` (``data.mode = "univariate"``): lengths, items,
      window starts and features equal to JAX's, the reconstruction,
      anomaly-detection and forecasting chains stitching one feature per
      window exactly as JAX's, and a univariate reconstruction trainer
      within 1e-5 of JAX's on copied weights;
  (d) each shipped MedTsLLM config (configs/datasets/*.toml, the Mamba and
      MoE ablations, and the dreams-classification and etth1-imputation
      task blocks on bidmc.toml's MedTsLLM settings, as chip_smoke.py
      composes them) building a CPU trainer with its ``data.dataset``
      unchanged (the family's stand-in and its description in the prompt
      head), only the backbone and the sizes cut, one eval batch finite;
      the examples ablation's pool, its batches' example inputs and a
      ``val()`` through them.
"""

import tomllib
import warnings
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from conftest import make_config
from medtsllm_tpu.data import BatchPipeline as JaxBatchPipeline
from medtsllm_tpu.data import get_dataset as jax_get_dataset
from medtsllm_tpu.data.readers.ventilator import TEST_CLIPS_SEG, TRAIN_CLIPS_AD, TRAIN_CLIPS_SEG
from medtsllm_tpu.tasks import get_trainer as jax_get_trainer
from medtsllm_tpu_torch.config import Config
from medtsllm_tpu_torch.data import BatchPipeline, dataset_lookup, get_dataset
from medtsllm_tpu_torch.data.readers.table import Table
from medtsllm_tpu_torch.tasks import get_trainer
from medtsllm_tpu_torch.weights import from_flax

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


# --------------------------------------------------------------------------
# the miniature files
# --------------------------------------------------------------------------

def _write_files(root: Path) -> None:
    rng = np.random.default_rng(11)

    (root / "ett").mkdir()
    n = 20 * 30 * 24
    df = pd.DataFrame(rng.normal(size=(n, 7)) * [1, 10, 0.1, 1, 100, 1e-3, 5],
                      columns=["HUFL", "HULL", "MUFL", "MULL", "LUFL", "LULL", "OT"])
    df.insert(0, "date", pd.date_range("2016-07-01", periods=n, freq="h"))
    df.to_csv(root / "ett" / "ETTh1.csv", index=False)

    (root / "psm").mkdir()
    cols = ["timestamp_(min)"] + [f"feature_{i}" for i in (3, 1, 2, 0, 4)]
    for fn, n in (("train.csv", 300), ("test.csv", 200)):
        df = pd.DataFrame(np.concatenate([np.arange(n)[:, None], rng.normal(size=(n, 5))],
                                         axis=1), columns=cols)
        df.iloc[3, 2] = np.nan
        df.to_csv(root / "psm" / fn, index=False)
    pd.DataFrame({"timestamp_(min)": np.arange(200), "label": rng.integers(0, 2, 200)}
                 ).to_csv(root / "psm" / "test_label.csv", index=False)

    (root / "msl").mkdir()
    np.save(root / "msl" / "MSL_train.npy", rng.normal(size=(300, 55)))
    np.save(root / "msl" / "MSL_test.npy", rng.normal(size=(200, 55)))
    np.save(root / "msl" / "MSL_test_label.npy", rng.integers(0, 2, 200))

    (root / "bidmc").mkdir()
    for fn, n, ids in (("train.csv", 240, [1, 2]), ("test.csv", 160, [3, 4])):
        labels = np.zeros(n, dtype=int)
        labels[np.arange(7, n, 23)] = 1
        pd.DataFrame({"Time": np.arange(n) / 125.0, "patient_id": np.repeat(ids, n // 2),
                      "RESP": rng.normal(size=n), "PLETH": rng.normal(size=n) * 40,
                      "ECG": rng.normal(size=n) * 1e-3, "label": labels}
                     ).to_csv(root / "bidmc" / fn, index=False)

    for sub in ("anom", "seg"):
        base = root / "mit_ecg" / "v2" / sub
        base.mkdir(parents=True)
        n = 200
        for fn, ids in (("train.csv", [100, 101]), ("test.csv", [102, 103])):
            df = pd.DataFrame({"time": np.arange(n), "patient_id": np.repeat(ids, n // 2),
                               "MLII": rng.normal(size=n), "V1": rng.normal(size=n)})
            if sub == "seg":
                labels = np.zeros(n, dtype=int)
                labels[np.arange(5, n, 17)] = 1
                df["label"] = labels
            df.to_csv(base / fn, index=False)
            pd.DataFrame({"data_desc": {i: f"subject {i}, age {30 + i % 50}" for i in ids}}
                         ).rename_axis("patient_id").to_csv(
                base / fn.replace(".csv", "_data_desc.csv"))
        if sub == "anom":
            pd.DataFrame({"time": np.arange(n), "patient_id": np.repeat([102, 103], n // 2),
                          "label": rng.integers(0, 2, n)}).to_csv(base / "test_label.csv",
                                                                   index=False)

    v4 = root / "ventilator" / "v4"
    v4.mkdir(parents=True)
    for clip in sorted(set(TRAIN_CLIPS_SEG + TEST_CLIPS_SEG + TRAIN_CLIPS_AD)):
        n = 100
        df = pd.DataFrame({"dt": np.arange(n) / 100.0, "pressure": rng.normal(size=n) * 20,
                           "flow": rng.normal(size=n) * 30,
                           "label": rng.integers(-1, 2, n)})
        df.to_csv(v4 / f"{clip}.csv", index=False)
    v1 = root / "ventilator" / "v1"
    v1.mkdir()
    for i in range(3):
        n = 120 + 40 * i
        df = pd.DataFrame({"flow": rng.normal(size=n), "time": np.arange(n),
                           "pressure": rng.normal(size=n) * 10})
        df.to_csv(v1 / f"patient_{800 + i}_vent_w_1.csv", index=False)

    (root / "ludb").mkdir()
    rows = []
    for patient in (1, 2):
        for lead in ("ii", "i", "v1"):  # the leads' order of appearance is not sorted
            for t in range(80):
                rows.append({"time": f"0 days 00:00:{t / 500.0:09.6f}",
                             "patient_id": patient, "lead": lead, "ecg": float(rng.normal()),
                             "label": int(rng.integers(0, 4))})
    df = pd.DataFrame(rows).sample(frac=1.0, random_state=0)  # rows out of order
    for fn in ("train.csv", "test.csv"):
        df.to_csv(root / "ludb" / fn, index=False)
    for fn in ("train_data_desc_cleaned.csv", "test_data_desc_cleaned.csv"):
        pd.DataFrame({"data_desc": {1: "subject one", 2: "subject two, paced"}}
                     ).rename_axis("patient_id").to_csv(root / "ludb" / fn)

    base = root / "dreams" / "v2"
    base.mkdir(parents=True)
    n = 400
    for fn in ("train.csv", "test.csv"):
        df = pd.DataFrame({"ts": np.arange(n) / 200.0, "patient_ID": np.ones(n, int)})
        for c in ["FP1-A1", "CZ-A1", "O1-A1", "FP2-A1", "O2-A1", "EOG1-A1", "EOG2-A1"]:
            df[c] = rng.normal(size=n)
        df.to_csv(base / fn, index=False)
    pd.DataFrame({"ts": np.arange(n) / 200.0, "patient_ID": np.ones(n, int),
                  "EEG_label": rng.integers(0, 2, n), "EOG_label": rng.integers(0, 2, n),
                  "ALL_label": rng.integers(0, 2, n)}).to_csv(base / "test_label.csv",
                                                              index=False)
    for fn in ("train_data_desc.csv", "test_data_desc.csv"):
        pd.DataFrame({"data_desc": {1: "sleepy"}}).rename_axis("patient_ID").to_csv(base / fn)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    _write_files(root)
    return root


DREAMS = {"version": "v2", "features": "eeg", "labels": "eeg", "downsample_factor": 2}
# (dataset, task, its [datasets.<name>] table, extra overrides)
REAL_CASES = [
    ("ETTh1", "forecasting", {}, {}),
    ("ETTh1", "imputation", {}, {}),
    ("PSM", "anomaly_detection", {}, {}),
    ("PSM", "reconstruction", {}, {}),
    ("MSL", "anomaly_detection", {}, {}),
    ("MSL", "forecasting", {}, {}),
    ("bidmc", "segmentation", {}, {}),
    ("bidmc", "reconstruction", {}, {}),
    ("ECG", "segmentation", {"version": "v2"}, {}),
    ("ECG", "anomaly_detection", {"version": "v2"}, {}),
    ("ECG", "reconstruction", {}, {}),
    ("ventilator", "semantic_segmentation", {"version": "v4", "split_version": "v1"}, {}),
    ("ventilator", "anomaly_detection", {}, {}),
    ("ventilator", "reconstruction", {}, {}),
    ("ludb", "semantic_segmentation", {"version": "v3"}, {}),
    ("ludb", "forecasting", {}, {}),
    ("dreams", "semantic_segmentation", DREAMS, {}),
    ("dreams", "classification", dict(DREAMS, downsample_factor=1),
     {"tasks.classification.window_label": "any"}),
    ("dreams", "anomaly_detection", {"version": "v2", "features": "eog", "labels": "eog"}, {}),
    ("dreams", "reconstruction", {"features": "all", "labels": "all"}, {}),
]


def _cfg(dataset, task, ds_table, over, root=None, model="dlinear", mode="multivariate"):
    pred = 8 if task == "forecasting" else 16
    cfg = make_config(task=task, model=model, dataset=dataset, hist=16, pred=pred, step=8,
                      **over)
    if root is not None:
        cfg["paths"] = {"data": str(root)}
        cfg.data.allow_synthetic = False
    cfg.data.mode = mode
    if ds_table:
        cfg["datasets"] = {dataset: ds_table}
    return cfg


def _hold(td, jd):
    """Everything a split of the port holds equal to JAX's."""
    assert len(td) == len(jd) > 0
    assert td.data.dtype == jd.data.dtype == np.float32 and np.array_equal(td.data, jd.data)
    for a in ("labels", "clip_ids", "timestamps"):
        got, want = getattr(td, a, None), getattr(jd, a, None)
        assert (got is None) == (want is None), a
        if want is not None:
            assert got.dtype == want.dtype and np.array_equal(got, want), a
    assert td.clip_descriptions == jd.clip_descriptions
    assert (td.n_features, td.real_features, td.n_points, td.n_classes, td.clip_dataset,
            td.univariate, td.step_size) == (jd.n_features, jd.real_features, jd.n_points,
                                            jd.n_classes, jd.clip_dataset, jd.univariate,
                                            jd.step_size)
    assert td.description == jd.description and td.task_description == jd.task_description
    idx = np.arange(len(jd))
    assert np.array_equal(td.x_starts(idx), jd.x_starts(idx))
    if jd.clip_dataset:
        assert np.array_equal(td.mask, jd.mask)
    for jb, tb in zip(JaxBatchPipeline(jd, 8), BatchPipeline(td, 8)):
        assert set(tb) == set(jb)
        for k in jb:
            if k == "examples":
                for (ta, tx), (ja, jx) in zip(tb[k], jb[k]):
                    assert ta == ja and np.array_equal(tx, jx)
            elif isinstance(jb[k], list):
                assert tb[k] == jb[k], k
            else:
                assert tb[k].dtype == jb[k].dtype and np.array_equal(tb[k], jb[k]), k


@pytest.mark.parametrize("dataset,task,ds_table,over", REAL_CASES,
                         ids=[f"{d}-{t}" for d, t, *_ in REAL_CASES])
def test_real_files_match_jax(data_root, dataset, task, ds_table, over):
    cfg = _cfg(dataset, task, ds_table, over, data_root)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the files are read: no stand-in
        for split in ("train", "val", "test"):
            _hold(get_dataset(cfg, split), jax_get_dataset(cfg, split))


def test_ecg_examples_match_jax(data_root):
    """ECG segmentation under MedTsLLM's prompting.examples: the example
    pool (data between consecutive boundaries) and each item's example."""
    cfg = _cfg("ECG", "segmentation", {"version": "v2"}, {}, data_root, model="medtsllm")
    cfg["models"] = {"medtsllm": {"prompting": {"examples": True, "example_pool": 5}}}
    for split in ("train", "test"):
        td, jd = get_dataset(cfg, split), jax_get_dataset(cfg, split)
        assert td.n_examples == jd.n_examples == 5
        _hold(td, jd)


def test_ecg_label_file_must_align(data_root, tmp_path):
    """The anomaly label file's time and patient_id must match the data
    file's, in both packages."""
    base = tmp_path / "mit_ecg" / "v2" / "anom"
    base.mkdir(parents=True)
    src = data_root / "mit_ecg" / "v2" / "anom"
    for fn in ("train.csv", "test.csv", "train_data_desc.csv", "test_data_desc.csv"):
        (base / fn).write_text((src / fn).read_text())
    lbl = pd.read_csv(src / "test_label.csv")
    lbl.loc[7, "time"] = 1000
    lbl.to_csv(base / "test_label.csv", index=False)
    cfg = _cfg("ECG", "anomaly_detection", {}, {}, tmp_path)
    with pytest.raises(AssertionError):
        jax_get_dataset(cfg, "test")
    with pytest.raises(ValueError, match="test_label"):
        get_dataset(cfg, "test")


def test_float_parsing_against_pandas(data_root):
    """Every float column of every fixture: equal to pandas' round-trip
    parse (correctly rounded, as ``float()``), and within 1e-12 relative of
    its default parse, which differs for some values (the case the float32
    data must survive bit-equal, as test_real_files_match_jax shows)."""
    n_diff = n_all = 0
    for path in sorted(data_root.rglob("*.csv")):
        df, table = pd.read_csv(path), Table(path)
        exact = pd.read_csv(path, float_precision="round_trip")
        assert list(df.columns) == table.columns
        for col in df.columns:
            if df[col].dtype.kind != "f":
                continue
            got, want = table.floats(col), df[col].to_numpy(dtype=np.float64)
            np.testing.assert_array_equal(got, exact[col].to_numpy(dtype=np.float64))
            both = np.isnan(got) & np.isnan(want)
            assert np.array_equal(np.isnan(got), np.isnan(want)), (path, col)
            diff = np.abs(got - want)[~both]
            assert (diff <= 1e-12 * np.abs(want[~both])).all(), (path, col)
            n_diff += int((diff > 0).sum())
            n_all += int((~both).sum())
    assert n_all > 10000 and n_diff > 0, (n_diff, n_all)


def test_table_reads_what_pandas_reads(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("b,a,id,label\n1.5,,3,1.0\nnan,2e-3,4,0.0\n\"7\",NA,5,2.9\n")
    table, df = Table(path), pd.read_csv(path)
    assert table.columns == list(df.columns)
    assert table.difference(["id"]) == list(df.columns.difference(["id"]))
    assert table.without(["a", "id"]) == list(df.drop(columns=["a", "id"]).columns)
    for col in ("a", "b"):
        np.testing.assert_array_equal(table.floats(col), df[col].to_numpy(dtype=float))
    for col in ("id", "label"):
        assert np.array_equal(table.ints(col), df[col].values.astype(int)), col
    with pytest.raises(KeyError):
        table.without(["missing"])


# --------------------------------------------------------------------------
# (b) the stand-ins
# --------------------------------------------------------------------------

STANDIN_CASES = [(name, task) for name, cls in sorted(dataset_lookup.items())
                 if name not in ("ETTh2", "ETTm1", "ETTm2")
                 for task in cls.supported_tasks if task != "pretraining"]


@pytest.mark.parametrize("name,task", STANDIN_CASES, ids=[f"{n}-{t}" for n, t in STANDIN_CASES])
def test_standins_match_jax(tmp_path, name, task):
    ds_table = dict(DREAMS) if name == "dreams" else {}
    over = ({"tasks.classification.window_label": "majority"}
            if task == "classification" else {})
    cfg = _cfg(name, task, ds_table, over)
    cfg["paths"] = {"data": str(tmp_path)}  # empty: every family falls back
    # the families whose stand-in comes with a warning (JAX's ETT and pooled
    # ventilator series have none)
    warns = name not in ("synthetic", "ETTh1") and not (
        name == "ventilator" and task in ("forecasting", "reconstruction"))
    for mode in ("multivariate", "univariate"):
        cfg.data.mode = mode
        for split in ("train", "val", "test"):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                td = get_dataset(cfg, split)
            assert any("synthetic fixture" in str(w.message) for w in caught) == warns
            _hold(td, jax_get_dataset(cfg, split))


@pytest.mark.parametrize("name", sorted(set(dataset_lookup) - {"synthetic"}))
def test_allow_synthetic_false_raises(tmp_path, name):
    task = {"dreams": "anomaly_detection", "ludb": "semantic_segmentation"}.get(
        name, "reconstruction")
    cfg = _cfg(name, task, dict(DREAMS) if name == "dreams" else {}, {}, tmp_path)
    for ds_get in (jax_get_dataset, get_dataset):
        with pytest.raises(FileNotFoundError):
            ds_get(cfg, "train")


def test_remaining_data_refusals():
    cfg = _cfg("bidmc", "segmentation", {}, {})
    cfg.data.cols = "ECG"
    with pytest.raises(AssertionError):
        jax_get_dataset(cfg, "train")
    with pytest.raises(NotImplementedError, match="data.cols"):
        get_dataset(cfg, "train")
    for bad, err in (("bidmc-x", "Unknown dataset"), ("ludb", "not supported")):
        cfg = _cfg(bad, "anomaly_detection", {}, {})
        with pytest.raises(ValueError, match=err):
            get_dataset(cfg, "train")


# --------------------------------------------------------------------------
# (c) the univariate view
# --------------------------------------------------------------------------

def test_multi2uni_matches_jax(data_root):
    cfg = _cfg("bidmc", "segmentation", {}, {}, data_root, mode="univariate")
    for split in ("train", "test"):
        td, jd = get_dataset(cfg, split), jax_get_dataset(cfg, split)
        assert td.univariate and td.n_features == 1 and td.real_features == 3
        assert len(td) == 3 * len(td.base)
        idx = np.arange(len(jd))
        assert np.array_equal(td.features(idx), jd.features(idx))
        _hold(td, jd)


@pytest.mark.parametrize("task", ["reconstruction", "anomaly_detection", "forecasting"])
def test_univariate_chains_match_jax(task):
    """The stitched series of the same window predictions: each window
    fills its own feature."""
    from medtsllm_tpu.tasks import task_lookup as jax_tasks
    from medtsllm_tpu_torch.tasks import task_lookup
    over = {"tasks.anomaly_detection.normalize_by_feature": True}
    cfg = _cfg("synthetic", task, {}, over, mode="univariate")
    cfg.datasets.synthetic.n_points = 300
    jd, td = jax_get_dataset(cfg, "test"), get_dataset(cfg, "test")
    rows = list(BatchPipeline(td, 4))
    key = "y" if task == "forecasting" else "x_enc"
    out = {k: np.concatenate([b[k][b["valid"]] for b in rows]) for k in (key, "index")}
    if task == "anomaly_detection":
        out["x_enc"] = np.concatenate([b["x_enc"][b["valid"]] for b in rows])
        out["labels"] = np.concatenate([b["labels"][b["valid"]] for b in rows])
    out["pred"] = (out[key] + 0.2 * np.random.default_rng(1).standard_normal(
        out[key].shape)).astype(np.float32)
    objs = []
    for lookup, ds in ((jax_tasks, jax_get_dataset(cfg, "train")),
                       (task_lookup, get_dataset(cfg, "train"))):
        obj = object.__new__(lookup[task])
        obj.config, obj.train_dataset = cfg, ds
        obj.task_config = cfg.tasks.get(task, {})
        obj.run_eval = lambda pipeline, extra_keys=(): {k: out[k] for k in ("pred", *extra_keys)}
        objs.append(obj)
    want = objs[0].predict(JaxBatchPipeline(jd, 4))
    got = objs[1].predict(BatchPipeline(td, 4))
    if task == "anomaly_detection":
        for k in got:
            assert np.array_equal(got[k], want[k]), k
    else:
        for g, w in zip(got, want):
            assert g.shape[1] == 3 and np.array_equal(g, w)


def test_univariate_trainer_matches_jax():
    cfg = _cfg("synthetic", "reconstruction", {}, {}, model="medtsllm", mode="univariate")
    cfg.datasets.synthetic.n_points = 160
    cfg["models"] = {"medtsllm": {
        "d_model": 16, "d_ff": 16, "n_heads": 4, "num_tokens": 32,
        "covariate_mode": "concat", "embedding_downsample_mode": "linear",
        "patching": {"patch_len": 8, "stride": 4},
        "prompting": {"dataset": True, "task": True, "clip": False, "input_stats": True,
                      "examples": False, "input_stats_dim": 0, "input_stats_select": "all"},
        "llm": {"enabled": True, "llm": "llama-tiny", "llm_layers": 2, "prefix_cache": True,
                "load_in_4bit": False, "load_in_8bit": False}}}
    jt = jax_get_trainer("jax", cfg)
    tt = get_trainer("port", cfg, device="cpu")
    tt.load_state_dict(from_flax(jax.device_get(jt.params)))
    assert tt.model.n_features == 1 and tt.test_dataset.univariate
    for fn in ("val", "test"):
        (pj, yj), (pt, yt) = (jt.predict(getattr(jt, f"{fn}_pipeline")),
                              tt.predict(getattr(tt, f"{fn}_pipeline")))
        assert pt.shape == pj.shape and pt.shape[1] == 3 and np.array_equal(yt, yj)
        np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-5 * np.abs(pj).max())
        sj, st = getattr(jt, fn)(), getattr(tt, fn)()
        for k, v in sj.items():
            assert abs(st[k] - v) <= 1e-5 * max(abs(v), 1.0), k


# --------------------------------------------------------------------------
# (d) the shipped MedTsLLM configs, their data.dataset as shipped
# --------------------------------------------------------------------------

def _cut(raw: dict, llm: str) -> dict:
    """The shipped file with a tiny backbone and small fusion layers."""
    mc = raw["models"].get("timellm") or raw["models"]["medtsllm"]
    mc.update(d_model=16, d_ff=16, num_tokens=32)
    mc["llm"].update(llm=llm, llm_layers=2)
    if llm == "mixtral-tiny-128":
        mc["llm"]["moe_grouped"] = False
    raw["training"]["batch_size"] = 4
    raw["setup"]["dtype"] = "float32" if raw["setup"]["dtype"] == "mixed" else \
        raw["setup"]["dtype"]
    return raw


def _task_block(task_toml: str) -> dict:
    """A task file's task block on bidmc.toml's MedTsLLM settings, its
    dataset kept (chip_smoke.task_block_config without the synthetic
    data)."""
    raw = tomllib.loads((ROOT / "configs" / "datasets" / "bidmc.toml").read_text())
    block = tomllib.loads((ROOT / task_toml).read_text())
    for key in ("task", "history_len", "pred_len", "training", "tasks", "datasets"):
        raw.pop(key, None)
        if key in block:
            raw[key] = block[key]
    raw["data"] = block["data"]
    return raw


SHIPPED = {
    "configs/datasets/bidmc.toml": ("bidmc", "llama-tiny"),
    "configs/datasets/ecgmit-anom.toml": ("ECG", "llama-tiny"),
    "configs/datasets/ecgmit-seg.toml": ("ECG", "llama-tiny"),
    "configs/datasets/ludb.toml": ("ludb", "llama-tiny"),
    "configs/datasets/ventilator.toml": ("ventilator", "llama-tiny"),
    "configs/ablation/mamba-backbone.toml": ("ventilator", "mamba-tiny"),
    "configs/ablation/moe-backbone.toml": ("ventilator", "mixtral-tiny-128"),
    "configs/ablation/dreams-classification.toml": ("dreams", "llama-tiny"),
    "configs/ablation/etth1-imputation.toml": ("ETTh1", "llama-tiny"),
}


@pytest.mark.parametrize("path", sorted(SHIPPED))
def test_shipped_configs_run_on_their_standins(tmp_path, path):
    name, llm = SHIPPED[path]
    raw = (_task_block(path) if "classification" in path or "imputation" in path
           else tomllib.loads((ROOT / path).read_text()))
    raw = _cut(raw, llm)
    raw["paths"] = {"data": str(tmp_path)}
    cfg = Config(raw)
    assert cfg.data.dataset == name
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tt = get_trainer("port", cfg, device="cpu")
    pooled = name == "ETTh1" or cfg.task == "reconstruction"  # no stand-in warning
    assert any("synthetic fixture" in str(w.message) for w in caught) != pooled
    assert type(tt.test_dataset) is dataset_lookup[name]
    desc = dataset_lookup[name].description
    assert tt.preprocessor.dataset_description == desc
    batch = next(iter(tt.test_pipeline))
    # the prompt head holds [bos + "Dataset: <the family's description> " ...]
    head = np.asarray(tt.model_inputs(batch)["prefix_ids"])
    bos = tt.preprocessor.bos
    want = (tt.preprocessor._encode(bos) if bos else []) + tt.preprocessor._encode(
        f"Dataset: {desc} ")
    for row in head.reshape(-1, head.shape[-1]):
        row = list(row)
        assert any(row[i:i + len(want)] == want for i in range(len(row))), row
    out = tt.eval_dispatch(batch)
    assert out.shape[0] == cfg.training.batch_size and torch.isfinite(out).all()


def test_examples_ablation_builds_its_pool_and_runs_val(tmp_path):
    """configs/ablation/ecgmit-seg-examples.toml on the ECG stand-in: the
    pool, then a trainer whose batches carry the example (``example_ts``,
    ``post_prompt_ids``) through ``val()``."""
    raw = _cut(tomllib.loads((ROOT / "configs/ablation/ecgmit-seg-examples.toml").read_text()),
               "llama-tiny")
    raw["paths"] = {"data": str(tmp_path), "logdir": str(tmp_path / "logs")}
    with pytest.warns(UserWarning, match="synthetic fixture"):
        ds = get_dataset(Config(raw), "test")
    assert ds.examples_enabled and ds.n_examples > 0 and "examples" in ds[0]
    tt = get_trainer("port", Config(raw), device="cpu")
    inputs = tt.model_inputs(next(iter(tt.val_pipeline)))
    assert inputs["example_ts"].shape == (4, tt.preprocessor.example_len, 2)
    assert "post_prompt_ids" in inputs and inputs["prefix_ids"].ndim == 1
    scores = tt.val()
    assert "val/segment_miou" in scores and np.isfinite(scores["val/point_mae"])
