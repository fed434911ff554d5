"""The model registry (port of ``medtsllm_tpu/models/__init__.py``):
``model_lookup`` and ``build_model``. The models load on first use, as
JAX's do.

MedTsLLM (and its alias ``timellm``), GPT4TS over its GPT-2 backbone and
the four baselines that need no LLM backbone (DLinear, PatchTST, TimesNet,
FEDformer): every model of the JAX registry.
"""

from __future__ import annotations


def _lazy_lookup() -> dict:
    from .dlinear import DLinear
    from .fedformer import FEDformer
    from .gpt4ts import GPT4TS
    from .medtsllm import MedTsLLM
    from .patchtst import PatchTST
    from .timesnet import TimesNet
    return {"medtsllm": MedTsLLM, "timellm": MedTsLLM, "gpt4ts": GPT4TS, "dlinear": DLinear,
            "patchtst": PatchTST, "timesnet": TimesNet, "fedformer": FEDformer}


class _ModelLookup(dict):
    def __missing__(self, key):
        self.update(_lazy_lookup())
        return dict.__getitem__(self, key)


model_lookup = _ModelLookup()


def build_model(config, dataset, device):
    """The model of ``config.model`` for ``config.task`` on ``dataset``'s
    features, on ``device`` (MedTsLLM resolves its kernels' routes for
    it)."""
    cls = model_lookup[config.model]
    if config.task not in cls.supported_tasks:
        raise ValueError(f"{config.task} not supported by {config.model}")
    if config.model in ("medtsllm", "timellm"):
        return cls.from_config(config, dataset, device)
    return cls.from_config(config, dataset).to(device)
