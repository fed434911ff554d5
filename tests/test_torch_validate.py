"""The port's ``validate_config`` against JAX's (``medtsllm_tpu/config.py``):
the three configs JAX refuses that the port once accepted (imputation's
``mask_rate`` 0, classification's ``window_label`` "first", classification
with the mse loss) and a valid config of every task go through both
validators, which raise the same ``ConfigError`` text or both accept."""

import pytest

from conftest import make_config
from medtsllm_tpu.config import ConfigError as JaxConfigError
from medtsllm_tpu.config import validate_config as jax_validate
from medtsllm_tpu_torch.config import Config, ConfigError, validate_config

TASKS = ("forecasting", "reconstruction", "anomaly_detection", "segmentation",
         "semantic_segmentation", "pretraining", "classification", "imputation")


def _raw(task, loss="mse", **tables):
    aligned = task not in ("forecasting", "pretraining")
    cfg = make_config(task=task, model="medtsllm", hist=64, pred=64 if aligned else 32,
                      loss=loss)
    raw = cfg.to_dict()
    for name, entries in tables.items():
        raw.setdefault("tasks", {})[name] = entries
    return raw


CASES = {
    **{f"valid-{t}": (_raw(t, loss="ce" if t == "classification" else "mse"), None)
       for t in TASKS},
    "mask_rate-0": (_raw("imputation", imputation={"mask_rate": 0.0}),
                    "imputation mask_rate must be in (0, 1), got 0.0"),
    "mask_rate-1": (_raw("imputation", imputation={"mask_rate": 1.0}),
                    "imputation mask_rate must be in (0, 1), got 1.0"),
    "window_label-first": (_raw("classification", loss="ce",
                                classification={"window_label": "first"}),
                           "classification window_label must be majority/last/any, "
                           "got 'first'"),
    "classification-mse": (_raw("classification", loss="mse"),
                           "classification requires loss ce/cross_entropy/auto, got 'mse'"),
}


def _outcome(validate, error, raw, make):
    try:
        validate(make(raw))
    except error as e:
        return str(e)
    return None


@pytest.mark.parametrize("name", sorted(CASES))
def test_validate_config_matches_jax(name):
    raw, message = CASES[name]
    from medtsllm_tpu.config import Config as JaxConfig
    want = _outcome(jax_validate, JaxConfigError, raw, JaxConfig)
    got = _outcome(validate_config, ConfigError, raw, Config)
    assert got == want == message
