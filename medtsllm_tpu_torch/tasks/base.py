"""The task runtime (port of ``medtsllm_tpu/tasks/base.py``): datasets and
pipelines, parameter init, the optimizer and the loss, ``train_step`` and
the epoch loop ``train``, ``train_model_inputs`` / ``eval_model_inputs``,
``eval_prepare`` / ``eval_dispatch`` (plain and banked), the prefill of the
1-D prompt-head cache, the per-clip KV bank (``_clip_bank_lookup``),
``run_eval``, ``eval_n_points``, ``finalize_series`` (the clip mask) and
the score bookkeeping (``log_scores``, ``best_score``).

The dtype policy is the JAX package's (``setup.dtype``, ``Precision``):
every float parameter at one dtype, or under "mixed" the trainable fusion
layers at f32 and the frozen backbone at bf16. The mixed train step runs
the model at bf16 over bf16 casts of the parameters and of the float
inputs (``torch.func.functional_call``; the gradients reach the f32
parameters through the casts and Adam updates those), takes the loss on
the f32 predictions against the uncast inputs, and serves the prompt head
from a cache of its own, prefilled at bf16; eval runs in the parameters'
own precision, the residual stream f32.

Everything lives on one explicit device. The constant prompt head is
prefilled once per eval pass and every window attends it as prefix K/V (or
resumes the Mamba scan from its state); each pass refills the same tensors
in place. The train step serves it from the same cache when the model says
that is safe (frozen backbone, no backbone dropout). Per-clip heads ([B, P]
``prefix_ids``) are served in eval from a bank of per-layer K/V rows, one a
clip, filled on a miss by a batch-1 prefill and evicted least recently
used; the eval step gathers its rows from the bank by a [B] slot tensor
(the banked step). The train step embeds per-clip heads in its graph.

On a CUDA device the eval step and the train step each replay one
captured CUDA graph per input signature (``runtime/graph.py``, the
counterparts of JAX's jitted ``eval_step`` and ``train_step``; the train
graph holds the forward, the loss, the backward, the clip and the
optimizer's update, with the dropout generator registered);
``eval_step_eager`` and ``train_step_eager`` are the same steps run op by
op, which is what the CPU runs. Both loops take their batches from a
prefetch thread, host inputs go to the card by pinned, non-blocking
copies, and ``run_eval`` reads batch i-1 back while batch i runs, as the
JAX loops do.

Dropout masks come from a generator on the trainer's device seeded from
``setup.seed``. The losses and each epoch's val scores are also kept in
``self.losses`` and ``self.val_scores``.

The run's lifecycle is JAX's: the logger (``loggers/``) is made last in
``__init__`` and writes the run directory; ``log_epoch`` saves ``latest``
every epoch and ``best`` on an improvement (``runtime/checkpoint.py``:
the fusion layers only, the frozen backbone rebuilt from ``setup.seed``);
SIGUSR1 saves ``latest`` at the next step boundary and exits 0;
``from_run_id`` rebuilds a run from its ``config.toml`` and a checkpoint,
restored in place (the captured steps and the optimizer bind the
parameters by address), with a fresh optimizer state, as JAX's. With
``finetuning.enabled`` the trainer restores a pretraining run's checkpoint
(its output head left out) before the optimizer is built, and those
parameters form the optimizer's ``loaded`` group.
"""

from __future__ import annotations

import functools
import random
import signal
import sys
import tomllib
import warnings
import weakref
from pathlib import Path

import numpy as np
import torch

from ..config import Config, validate_config
from ..data import BatchPipeline, dedup_eval_series, get_dataset, prefetch, stitch_windows
from ..device import resolve_device
from ..loggers import get_logger
from ..loggers.base import logdir_base
from ..models.medtsllm import MedTsLLM, Precision, PromptBuilder
from ..runtime.checkpoint import load_checkpoint, restore_partial, wait_for_saves
from ..runtime.graph import StepGraphs, TrainGraphs
from ..runtime.optim import Optimizer
from ..weights import init_random_
from .losses import build_loss


class BaseTask:
    task: str = ""
    # the name of the task's figure of a split's predictions, if it has one
    figure: str | None = None

    def __init__(self, run_id, config, newrun=True, device="cuda"):
        if config.model not in ("medtsllm", "timellm"):
            raise NotImplementedError(f"model {config.model!r}: the port has MedTsLLM "
                                      "(ROADMAP queue 1, \"Baseline models and the ops "
                                      "library\")")
        validate_config(config)
        self.run_id = run_id
        self.config = config
        self.device = resolve_device(device)
        self.precision = Precision.from_config(config)
        seed = int(config.setup.seed)
        random.seed(seed)
        np.random.seed(seed)

        bs = config.training.batch_size
        self.build_datasets()
        self.train_pipeline = BatchPipeline(self.train_dataset, bs, shuffle=True, seed=seed)
        self.val_pipeline = BatchPipeline(self.val_dataset, bs)
        self.test_pipeline = BatchPipeline(self.test_dataset, bs)

        with torch.device(self.device):
            self.model = MedTsLLM.from_config(config, self.train_dataset, self.device)
        self.preprocessor = PromptBuilder(config, self.train_dataset, self.model)
        generator = torch.Generator(self.device).manual_seed(seed)
        init_random_(self.model, generator)
        warnings.warn(f"LLM {self.model.llm_id!r}: no weights are loaded — "
                      "random init (shapes and throughput faithful; task "
                      "quality not meaningful)")
        self._apply_param_dtype()
        self.model.eval()
        # (head ids, mixed train) or ("clip_bank", P, mixed train) ->
        # per-layer prefix tensors: ``_prefix_kv_store`` keeps them for the
        # trainer's life (a captured step reads them where they lie);
        # ``_prefix_kv_cache`` holds this pass's entries (a bank's
        # bookkeeping)
        self._prefix_kv_store = {}
        self._prefix_kv_cache = {}
        # (the step holds the model, not the trainer: no reference cycle
        # keeps a dropped trainer's device memory alive)
        self.step_graphs = (StepGraphs(functools.partial(eval_forward, self.model),
                                       self.device)
                            if self.device.type == "cuda" else None)

        self.load_pretrained()

        self.dropout_generator = torch.Generator(self.device).manual_seed(seed)
        loaded = set(self.loaded_params)
        self.optimizer = Optimizer(config, self.model.parameters(),
                                   loaded=[p for n, p in self.model.named_parameters()
                                           if n in loaded])
        self.loss_fn = build_loss(config.training.loss, self.task,
                                  getattr(self.train_dataset, "n_classes", 0))
        # the step binds the model, the policy, the loss, the optimizer and
        # the generator (not the trainer, as the eval step)
        self._train_update = functools.partial(train_update, self.model, self.precision,
                                               self.loss_fn, self.optimizer,
                                               self.dropout_generator)
        self.train_graphs = (TrainGraphs(self._train_update, self.device,
                                         self.optimizer.params, (self.dropout_generator,))
                             if self.device.type == "cuda" else None)
        self.epoch = 1
        self.step = 0
        self._in_train = False
        self._preempt_requested = False
        self.losses: list[float] = []
        self.val_scores: list[dict] = []
        direction = config.training.get("eval_metric_direction", "min")
        self.best_score = float("inf") if direction == "min" else float("-inf")

        self.logger = get_logger(self, config, newrun)
        # the handler holds the trainer weakly: a dropped trainer's device
        # memory is freed, not kept until the next trainer replaces it
        ref = weakref.ref(self)

        def on_sigusr1(signum, frame):
            trainer = ref()
            if trainer is not None:
                trainer.handle_termination(signum, frame)
        try:
            signal.signal(signal.SIGUSR1, on_sigusr1)
        except ValueError:
            pass  # not on the main thread

    def build_datasets(self) -> None:
        """The three splits of ``data.dataset`` (``get_dataset``)."""
        self.train_dataset = get_dataset(self.config, "train")
        self.val_dataset = get_dataset(self.config, "val")
        self.test_dataset = get_dataset(self.config, "test")

    # ------------------------------------------------------------------
    # eval step
    # ------------------------------------------------------------------

    def _apply_param_dtype(self) -> None:
        """Store each float parameter at the policy's dtype: ``param_dtype``,
        or under "mixed" bf16 for the frozen ones (``_apply_param_dtype``
        of the JAX trainer)."""
        for p in self.model.parameters():
            if p.is_floating_point():
                p.data = p.data.to(self.precision.storage(frozen=not p.requires_grad))

    def load_pretrained(self) -> None:
        """Pretraining -> finetuning transfer (``finetuning.enabled``): the
        checkpoint ``finetuning.pretrained_ckpt`` of run
        ``finetuning.pretrained_id`` under the logdir, its output head left
        out, restored in place; ``loaded_params`` names what it set."""
        ft = self.config.get("finetuning", {})
        self.finetuning = bool(ft.get("enabled", False))
        self.loaded_params: list[str] = []
        if not self.finetuning:
            return
        path = (logdir_base(self.config) / ft.pretrained_id / "checkpoints"
                / f"{ft.pretrained_ckpt}.ckpt")
        if not path.is_file():
            raise FileNotFoundError(f"finetuning.pretrained_id {ft.pretrained_id!r}: "
                                    f"no checkpoint at {path}")
        saved, _ = load_checkpoint(path)
        self.loaded_params = self.restore(self.model.drop_pretrained_heads(saved))

    def checkpoint_params(self) -> dict:
        """The state-dict entries a checkpoint holds (the model's
        ``checkpoint_tree``: not the frozen backbone), on the device."""
        return self.model.checkpoint_tree(self.model.state_dict())

    def restore(self, saved: dict) -> list[str]:
        """Copy a checkpoint's tensors into the parameters in place
        (``runtime.checkpoint.restore_partial``'s rules); returns the names
        set. The prompt-head caches are refilled at the next pass."""
        _, loaded = restore_partial(self.model.state_dict(), saved)
        self._prefix_kv_cache.clear()
        return loaded

    def load_state_dict(self, state: dict) -> None:
        """Replace every parameter (e.g. ``weights.from_flax``); each keeps
        its own storage dtype."""
        own = self.model.state_dict()
        if set(state) != set(own):
            raise KeyError(f"state dict mismatch: missing {sorted(set(own) - set(state))}, "
                           f"unexpected {sorted(set(state) - set(own))}")
        self.model.load_state_dict({k: v.to(self.device, own[k].dtype)
                                    for k, v in state.items()})
        self._prefix_kv_cache.clear()

    def model_inputs(self, batch: dict) -> dict:
        """Host batch -> model inputs (prompt token ids via the builder)."""
        return self.preprocessor(batch)

    def _to_device(self, arrays: dict) -> dict:
        """Host arrays -> tensors on the device; to a card through pinned
        memory without blocking the host (the caching host allocator keeps
        each pinned block until its copy has run)."""
        tensors = {k: torch.as_tensor(np.asarray(v)) for k, v in arrays.items()}
        if self.device.type == "cpu":
            return tensors
        return {k: t.pin_memory().to(self.device, non_blocking=True)
                for k, t in tensors.items()}

    def eval_model_inputs(self, batch: dict) -> dict:
        """Model inputs with the prompt head (``prefix_ids``) swapped for
        its per-layer KV: the cached constant head, or the per-clip rows
        gathered from the bank."""
        _, arrays = self.eval_prepare(batch)
        return gather_bank(arrays)

    def train_model_inputs(self, batch: dict) -> dict:
        """Train-side inputs: the 1-D prompt head served from the cache when
        ``model.train_prefix_cache_safe`` (the cache is then a constant of
        the optimization: same loss, same gradients), else embedded in the
        graph."""
        host = self.model_inputs(batch)
        ids = host.get("prefix_ids")
        if ids is not None and ids.ndim == 1 and self.model.train_prefix_cache_safe:
            del host["prefix_ids"]
            return dict(self._to_device(host), prefix_kv=self._prefix_kv(ids, train=True))
        return self._to_device(host)

    def train_step(self, arrays: dict, valid: torch.Tensor) -> torch.Tensor:
        """One optimizer step on a batch of model inputs -> the loss
        (detached, on the device; ``train_update``): on a card the captured
        graph of the inputs' signature (captured at its first call, which
        runs the step eagerly as the warm-up), on the CPU the eager step."""
        if self.train_graphs is None:
            return self.train_step_eager(arrays, valid)
        return self.train_graphs(dict(arrays, valid=valid))

    def train_step_eager(self, arrays: dict, valid: torch.Tensor) -> torch.Tensor:
        """The train step op by op, whatever the device."""
        return self._train_update(dict(arrays, valid=valid))

    def eval_prepare(self, batch: dict):
        """Host side of ``eval_dispatch`` (split out so a caller can time
        host preparation apart from the device work): ("plain", inputs with
        the constant head's cached ``prefix_kv``) or, for per-clip heads,
        ("banked", inputs with the bank (``prefix_bank``) and the rows'
        slots (``prefix_slots`` [B])). The bank's misses are prefilled into
        it here, on the current stream: after the previous step's work,
        which may still be reading the bank."""
        host = self.model_inputs(batch)
        ids = host.pop("prefix_ids", None)
        if ids is not None and ids.ndim == 2:
            bank, slots = self._clip_bank_lookup(ids)
            host["prefix_slots"] = np.asarray(slots, dtype=np.int64)
            return ("banked", dict(self._to_device(host), prefix_bank=bank))
        arrays = self._to_device(host)
        if ids is not None:
            arrays["prefix_kv"] = self._prefix_kv(ids)
        return ("plain", arrays)

    def eval_step(self, arrays: dict) -> torch.Tensor:
        """The eval step: on a card the captured graph of the inputs'
        signature (captured at its first call), on the CPU the eager step."""
        if self.step_graphs is None:
            return self.eval_step_eager(arrays)
        return self.step_graphs(arrays)

    @torch.inference_mode()
    def eval_step_eager(self, arrays: dict) -> torch.Tensor:
        """The eval step op by op, whatever the device."""
        return eval_forward(self.model, arrays)

    def eval_dispatch(self, batch: dict | None = None, prepared=None):
        if prepared is None:
            prepared = self.eval_prepare(batch)
        kind, arrays = prepared
        assert kind in ("plain", "banked"), kind
        return self.eval_step(arrays)

    @torch.no_grad()
    def _prefix_kv(self, ids: np.ndarray, train: bool = False):
        """Per-layer K/V of the 1-D prompt head (host token ids), prefilled
        once per eval pass and kept through the epoch's train steps (the
        backbone is frozen). A head seen before is prefilled into the
        tensors it had, in place, so a captured step that reads them stays
        valid. The head embeds at ts_emb's dtype, so cached and uncached
        forwards agree: f32 (the fusion layers promote to f32), except in
        the mixed train step, whose cache is its own (keyed by
        ``mixed_train``, as JAX's) and embeds at bf16 over the backbone's
        parameters, which are stored at bf16 already. Built under
        ``no_grad``, not ``inference_mode``: the train step's backward saves
        the cached K/V (K2) and SSM state (K9)."""
        mixed_train = train and self.precision.mixed
        key = (ids.tobytes(), mixed_train)
        kv = self._prefix_kv_cache.get(key)
        if kv is None:
            fresh = self.model.prefill(
                torch.as_tensor(ids, device=self.device),
                self.precision.compute_dtype if mixed_train else torch.float32)
            kv = self._prefix_kv_store.setdefault(key, fresh)
            if kv is not fresh:
                for layer, new in zip(kv, fresh):
                    for t, n in zip(layer, new):
                        t.copy_(n)
            self._prefix_kv_cache[key] = kv
        return kv

    # -- the per-clip KV bank (medtsllm_tpu/tasks/base.py:375-463) ---------
    #
    # Clip descriptions come from a small finite set, so each distinct head
    # row [P] is prefilled once and banked; eval batches gather their rows
    # from the bank. Eval windows come in position order, so a clip's
    # windows arrive together and a few slots get nearly every hit.

    def _clip_cache_slots(self) -> int:
        return max(2, self.preprocessor.cfg["clip_cache_slots"])

    @torch.no_grad()
    def _clip_bank_lookup(self, ids: np.ndarray):
        """Fill the bank's misses for a [B, P] batch of head rows: each
        missed row is prefilled (batch 1) into a free slot or over the
        least recently used one (the rows of this batch pinned); returns
        (the bank, per layer (k, v) [cap, KV, P, D], and the B slots).

        The bookkeeping (capacity ``max(clip_cache_slots, B)``, growing
        with a wider batch; the slot of each row; the tick of each slot's
        last use; the pass's misses and evictions) lives in
        ``_prefix_kv_cache``, so it starts afresh every pass, as JAX's.
        The tensors live in ``_prefix_kv_store``: allocated at the first
        miss of their key (outside any graph's pool), written in place row
        by row, and kept across passes and ``load_state_dict``, so a
        captured step that reads them stays valid. Growth allocates anew,
        and the steps then capture anew. Eval only (JAX's key with
        ``mixed_train`` False): the train step embeds per-clip heads."""
        key = ("clip_bank", ids.shape[1], False)
        book = self._prefix_kv_cache.get(key)
        if book is None:
            # cap >= B: a batch pins at most B rows, so an unpinned slot is
            # always left to evict
            book = {"slot_of": {}, "row_of": {}, "last_use": {}, "tick": 0,
                    "cap": max(self._clip_cache_slots(), ids.shape[0]),
                    "misses": 0, "evictions": 0}
            self._prefix_kv_cache[key] = book
        book["cap"] = max(book["cap"], ids.shape[0])
        if key in self._prefix_kv_store:  # room for a wider batch
            self._bank_tensors(key, self._prefix_kv_store[key], book["cap"])
        slots = []
        for row in ids:
            rb = row.tobytes()
            slot = book["slot_of"].get(rb)
            if slot is None:
                fresh = self.model.prefill(torch.as_tensor(row[None], device=self.device))
                bank = self._bank_tensors(key, fresh, book["cap"])
                if len(book["slot_of"]) < book["cap"]:
                    slot = len(book["slot_of"])
                else:  # evict the least recently used row not in this batch
                    pinned = set(slots)
                    slot = min((s for s in book["last_use"] if s not in pinned),
                               key=book["last_use"].__getitem__)
                    del book["slot_of"][book["row_of"][slot]]
                    book["evictions"] += 1
                for layer, new in zip(bank, fresh):
                    for t, n in zip(layer, new):
                        t[slot].copy_(n[0])
                book["slot_of"][rb] = slot
                book["row_of"][slot] = rb
                book["misses"] += 1
            book["tick"] += 1
            book["last_use"][slot] = book["tick"]
            slots.append(slot)
        return self._prefix_kv_store[key], slots

    def _bank_tensors(self, key, like, cap: int):
        """The bank of ``key`` with room for ``cap`` rows: the kept tensors,
        or new zeros shaped like ``like``'s rows with the old rows copied
        in."""
        bank = self._prefix_kv_store.get(key)
        if bank is not None and bank[0][0].shape[0] >= cap:
            return bank
        grown = tuple(tuple(torch.zeros((cap,) + t.shape[1:], dtype=t.dtype,
                                        device=t.device) for t in layer)
                      for layer in like)
        if bank is not None:
            for layer, old in zip(grown, bank):
                for t, o in zip(layer, old):
                    t[:o.shape[0]].copy_(o)
        self._prefix_kv_store[key] = grown
        return grown

    # ------------------------------------------------------------------
    # train loop (medtsllm_tpu/tasks/base.py:577-617)
    # ------------------------------------------------------------------

    def train(self):
        """For each epoch: set the epoch's learning rate, run the shuffled
        train batches through ``train_step``, log the losses, then ``val()``.
        A step's loss is read back while the next step runs, as JAX does (on
        a card the loss held is a clone of the graph's, which the next replay
        overwrites)."""
        epochs = int(self.config.training.epochs)
        # a SIGUSR1 in the loop waits for the next step boundary, or the
        # epoch's end (handle_termination)
        self._in_train = True
        try:
            for epoch in range(self.epoch - 1, epochs):
                print(f"Epoch {epoch + 1}/{epochs}")
                self.optimizer.set_epoch(epoch)
                pending = None
                for batch in prefetch(iter(self.train_pipeline)):
                    arrays = self.train_model_inputs(batch)
                    loss = self.train_step(arrays, arrays["valid"])
                    if self._preempt_requested:
                        self._save_and_exit()
                    if pending is not None:
                        self.log_step(*pending)
                    pending = (loss, int(batch["valid"].sum()))
                if pending is not None:
                    self.log_step(*pending)
                self.log_epoch(self.val())
                if self._preempt_requested:
                    self._save_and_exit()
        finally:
            self._in_train = False

    # ------------------------------------------------------------------
    # logging, checkpoints, the lifecycle (medtsllm_tpu/tasks/base.py:709-782)
    # ------------------------------------------------------------------

    def log_step(self, loss, n_valid: int) -> None:
        self.step += n_valid  # real samples: the padded final batch counts fewer
        self.losses.append(float(loss))
        print(f"step {self.step}: train/loss {self.losses[-1]:.6f}")
        self.logger.log_scores({"train/loss": self.losses[-1]})

    def log_epoch(self, scores: dict) -> None:
        """Log an epoch's val scores and LRs (``train/finetune_lr``: the
        loaded group's); then, the epoch and ``best_score`` (by
        ``training.eval_metric`` in its direction) advanced first so the
        meta is the resume point, save ``latest``, and ``best`` on an
        improvement (``training.save_best``)."""
        self.val_scores.append(dict(scores))
        lrs = self.optimizer.get_last_lr()
        scores = dict(scores, **{"train/lr": lrs[0]})
        if len(lrs) > 1:
            scores["train/finetune_lr"] = lrs[1]
        self.logger.log_scores(scores)
        self.epoch += 1
        metric = scores["val/" + self.config.training.get("eval_metric", "mse")]
        direction = self.config.training.get("eval_metric_direction", "min")
        improved = ((direction == "min" and metric < self.best_score)
                    or (direction == "max" and metric > self.best_score))
        if improved:
            self.best_score = metric
        self.logger.save_state("latest")
        if improved and self.config.training.get("save_best", True):
            self.logger.save_state("best")

    def log_scores(self, scores=None, **kwscores) -> None:
        self.logger.log_scores(dict(scores or {}) | kwscores)

    def log_figure(self, name: str, plot, *args) -> None:
        """Hand the figure ``plot(*args)`` draws to the logger, when the
        logger takes figures (tensorboard, wandb) and matplotlib imports;
        without matplotlib, warn once and draw nothing. No score depends on
        a figure."""
        if not self.logger.takes_figures:
            return
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            warnings.warn("matplotlib not installed: the task figures are not drawn")
            return
        fig = plot(*args)
        self.logger.log_figure(fig, name)
        plt.close(fig)

    def log_end(self) -> None:
        wait_for_saves()  # the async checkpoint writes are on disk
        self.logger.log_end()

    def handle_termination(self, signum, frame) -> None:
        """SIGUSR1: save ``latest`` and exit 0; in ``train()``, at the next
        step boundary or the epoch's end (the loop's checks), so the
        checkpoint is a step boundary. There the handler only sets a flag:
        it runs between any two bytecodes of the main thread, which may
        hold a lock the save and the exit need (a logger's writer's, in the
        middle of a step's log)."""
        if self._in_train:
            self._preempt_requested = True
            return
        self._save_and_exit()

    def _save_and_exit(self) -> None:
        print("Interrupted!")
        self.logger.save_state("latest", async_=False)  # on disk before the exit
        self.log_end()
        sys.exit(0)

    @classmethod
    def from_run_id(cls, run_id, cfg=None, ckpt="latest", basepath=None, device="cuda"):
        """The run ``run_id`` rebuilt from ``<basepath>/<run_id>/config.toml``
        (``cfg`` deep-merged on top) and its checkpoint ``ckpt``, restored in
        place, with ``epoch``, ``step`` and ``best_score`` from the
        checkpoint's meta and a fresh optimizer state."""
        ckpt = ckpt or "latest"
        rundir = (Path(basepath) if basepath is not None
                  else Path.cwd() / "outputs" / "logs") / run_id
        config = Config(tomllib.loads((rundir / "config.toml").read_text()))
        if cfg is not None:
            # {"training": {"epochs": 20}} tweaks one field of [training]
            config = config.merge(cfg)
        trainer = cls(run_id, config, newrun=False, device=device)
        saved, meta = load_checkpoint(rundir / "checkpoints" / f"{ckpt}.ckpt")
        trainer.restore(saved)
        trainer.epoch = meta["epoch"]
        trainer.step = meta["step"]
        if "best_score" in meta:
            trainer.best_score = meta["best_score"]
        return trainer

    # ------------------------------------------------------------------
    # eval loop
    # ------------------------------------------------------------------

    @staticmethod
    def _readback(out: torch.Tensor, valid: np.ndarray):
        """Start the copy of a step's output to the host; returns a function
        that waits for it and gives the valid rows in f32. On a card the
        copy goes to pinned memory without blocking, then an event, so the
        wait is for this batch only."""
        out = out.float()
        if out.device.type == "cpu":
            return lambda: out.numpy()[valid]
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(out.device))

        def wait() -> np.ndarray:
            done.synchronize()
            return host.numpy()[valid]
        return wait

    def run_eval(self, pipeline, extra_keys=()):
        """Run the eval step over a pipeline; returns the stacked valid
        per-window predictions and the requested batch keys. One deep, as
        JAX's loop (``medtsllm_tpu/tasks/base.py:623-648``): batch i-1 is
        read back after batch i is dispatched."""
        self._prefix_kv_cache.clear()  # parameters may have changed
        preds, extras = [], {k: [] for k in extra_keys}
        pending = None
        for batch in prefetch(iter(pipeline)):
            v = batch["valid"]
            fetch = self._readback(self.eval_dispatch(batch), v)
            for k in extra_keys:
                extras[k].append(np.asarray(batch[k])[v])
            if pending is not None:
                preds.append(pending())
            pending = fetch
        if pending is not None:
            preds.append(pending())
        result = {"pred": np.concatenate(preds)}
        for k in extra_keys:
            result[k] = np.concatenate(extras[k])
        return result

    def eval_n_points(self, dataset, include_history: bool = False) -> int:
        """Full-series buffer length (``eval_n_points`` of the JAX trainer):
        a clip dataset's whole series, else the span its windows cover (a
        univariate view's windows counted once, not once a feature)."""
        if dataset.clip_dataset:
            return dataset.n_points
        n_windows = len(dataset)
        if dataset.univariate:
            n_windows //= dataset.real_features
        n = self.config.pred_len + (n_windows - 1) * dataset.step_size
        return n + self.config.history_len if include_history else n

    def finalize_series(self, dataset, *series):
        """Keep a clip dataset's ``mask`` points, else apply the step >
        pred_len de-duplication; check that every float series is
        complete."""
        step, pred = dataset.step_size, self.config.pred_len
        out = [arr[dataset.mask] if dataset.clip_dataset
               else dedup_eval_series(arr, step, pred) if step > pred else arr
               for arr in series]
        for arr in out:
            if np.issubdtype(arr.dtype, np.floating) and np.isnan(arr).any():
                raise ValueError("unfilled points after stitching")
        return out if len(out) > 1 else out[0]

    def evaluate(self, pipeline, split: str | None = None) -> dict:
        """A split's scores, unprefixed: ``score`` of ``predict``'s series;
        a task with a figure (``figure``) draws ``plot_predictions`` of them
        as ``<split>/<figure>``."""
        results = self.predict(pipeline)
        if split is not None and self.figure is not None:
            self.log_figure(f"{split}/{self.figure}", self.plot_predictions, *results)
        return self.score(*results)

    def _eval_split(self, pipeline, split: str) -> dict:
        scores = {f"{split}/{k}": v for k, v in self.evaluate(pipeline, split).items()}
        self.log_scores(scores)
        return scores

    def val(self):
        return self._eval_split(self.val_pipeline, "val")

    def test(self):
        return self._eval_split(self.test_pipeline, "test")


def stitch_channels(dataset, values: np.ndarray, starts: np.ndarray, n_points: int,
                    idx: np.ndarray) -> np.ndarray:
    """Per-window values [W, L, C] -> a series [n_points, real_features];
    under the univariate view (``data.mode = "univariate"``) window ``idx``
    fills its own feature."""
    feats = dataset.features(idx) if dataset.univariate else None
    return stitch_windows(values[..., 0] if feats is not None else values, starts, n_points,
                          n_channels=dataset.real_features, features=feats)


def train_update(model, precision, loss_fn, optimizer, generator,
                 arrays: dict) -> torch.Tensor:
    """One optimizer step on a batch of model inputs (``arrays["valid"]``
    the rows the loss averages) -> the loss, detached. The model runs in
    train mode (dropout from ``generator``, the einsum reprogramming graph),
    under "mixed" at bf16 over bf16 casts of the parameters and the float
    inputs; its predictions are taken in f32 against the uncast inputs, and
    only the fusion layers update."""
    model.train()
    try:
        if precision.mixed:
            cd = precision.compute_dtype
            params = {n: _cast(p, cd) for n, p in model.named_parameters()}
            pred = torch.func.functional_call(model, params, (_cast(arrays, cd),),
                                              {"generator": generator})
        else:
            pred = model(arrays, generator=generator)
        loss = loss_fn(pred.float(), arrays, arrays["valid"])
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
    finally:
        model.eval()
    return loss.detach()


def eval_forward(model, arrays: dict) -> torch.Tensor:
    """The forward of the eval step, captured as it is: the bank's rows
    gathered first (the banked step), then the model."""
    return model(gather_bank(arrays))


def gather_bank(arrays: dict) -> dict:
    """Banked inputs -> model inputs: ``prefix_kv`` = the bank's rows at
    ``prefix_slots`` (per layer, ``index_select`` on dim 0: K2 then runs
    with a per-row prefix); other inputs as they are."""
    bank = arrays.get("prefix_bank")
    if bank is None:
        return arrays
    slots = arrays["prefix_slots"]
    out = {k: v for k, v in arrays.items() if k not in ("prefix_bank", "prefix_slots")}
    out["prefix_kv"] = tuple(tuple(t.index_select(0, slots) for t in layer)
                             for layer in bank)
    return out


def _cast(tree, dtype: torch.dtype):
    """Float tensors of a tensor, tuple, list or dict at ``dtype``; the
    rest as it is."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, (tuple, list)):
        return type(tree)(_cast(t, dtype) for t in tree)
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree
