"""The captured steps: the port's counterpart of ``jax.jit`` on the eval
step (``medtsllm_tpu/tasks/base.py:547``) and on the train step (``:501``).

``StepGraphs`` runs a step function (the task's eval forward) as one CUDA
graph per input signature. The key (``step_key``) is the shape and dtype of
every input array, plus the shape, dtype and address of every prefix K/V
tensor and every tensor of the per-clip KV bank: the prompt-head cache and
the bank are bound into the graph by address, not copied, and the task
refills those same tensors in place (the bank row by row, on the step's
stream, so a write is ordered after every replay enqueued before it). The
bank's slots are an input like any other: the gather of the rows runs
inside the graph. As with ``jax.jit``, a new prompt bucket captures a new
graph.

- The first call of a key runs the forward eagerly on a side stream (the
  warm-up: each launcher's one-time setup and cuBLAS / cuDNN handles and
  workspaces) and returns that output. It then captures the forward into a
  ``torch.cuda.CUDAGraph`` on the same stream, reading static input buffers
  allocated before the capture.
- Every later call copies its inputs into the static buffers, replays the
  graph and returns a clone of the static output, which the next replay
  overwrites.
- A capture that fails raises, the generators it registered set back to
  where they were. Nothing falls back to the eager step.

What the graph freezes: parameter and buffer addresses (``load_state_dict``
copies in place, so they hold), and every host-side choice the forward made
at capture time (the attention route's ``K4_MIN_KEYS``, backend flags), as
a trace does.

Memory: the graphs of one ``StepGraphs`` share one memory pool. This is
safe because every replay runs on the caller's one stream, so no two
graphs run at once; the static inputs, the prefix K/V and the bank are
allocated outside the pool; and each graph's static output stays referenced, so no
other capture reuses it, while the caller gets a clone made before any
other replay. A graph's intermediates are dead once its replay ends, so a
later replay of another graph may overwrite them.

Launch counters: a replay makes no Python call, so the kernel wrappers'
counters (``launch_counters``) are read around the capture, set back to
their values before it (a capture launches nothing), and each replay adds
the capture's delta: the counts stay those of the kernels the card runs.

``TrainGraphs`` captures a whole train step the same way: the forward in
train mode, the loss, ``backward`` (its kernels run on autograd's device
thread, on the stream of their forward: the capturing one), the clip and
the optimizer's update. What it adds:

- The warm-up is a real step: it updates the parameters, advances the
  dropout generator and creates the optimizer's state (outside any pool),
  and its loss is the call's. The capture then computes nothing, so the
  parameters, the optimizer's state and the generator stay as the warm-up
  left them.
- The parameters, the optimizer's state and the epoch's LR tensor are read
  and written where they lie (they are updated in place); the dropout
  generator is registered with every graph, so a replay draws the masks
  the eager step would and advances the generator as far.
- Each graph's gradients (``.grad``, allocated in the pool by its
  ``backward``) stay referenced with it: a later warm-up sets every
  ``.grad`` to None. After a call, each parameter's ``.grad`` holds that
  step's gradient, as after the eager step (after a capture, the
  warm-up's, copied in).
- Its graphs share a pool of their own, apart from the eval graphs'.
- ``phase`` (a function of no arguments, read before each call) joins the
  key: the optimizer's accumulation phase, so an accumulate-only step and
  an accumulate-and-update step are two graphs.

Every ``StepGraphs`` and ``TrainGraphs`` on a device warms up and captures
on one side stream (``capture_stream``), made once for the process. cuBLAS
allocates a workspace (through the caching allocator) for each (handle,
stream) pair it runs on and keeps it until the process ends, since a
captured graph binds it by address; the caller's thread and autograd's
backward thread hold a handle each. With a stream per ``StepGraphs``, each
deleted trainer left its streams' workspaces behind (0.0635 GiB for a
GPT4TS trainer on an H100, chip_smoke phase 6p); on the shared stream they
are made once, by the first capture, and every later trainer reuses them.
"""

from __future__ import annotations

import time

import torch


def launch_counters() -> dict:
    """Every kernel wrapper's launch counter, by name: the objects whose
    ``launches`` a wrapper adds one to where it launches its kernel."""
    from ..ops.kernels import flash_attention as k4
    from ..ops.kernels import grouped_matmul as gm
    from ..ops.kernels import reprogramming as k3
    from ..ops.kernels import rope_attention as k2
    from ..ops.kernels import selective_scan as ss
    from ..ops.kernels import w4a8 as k5
    from ..ops.kernels import w8a8 as k1
    return {"w8a8_quantize": k1.quantize_rows, "w8a8_gemm": k1.int8_gemm,
            "rope_attention": k2.rope_attention, "flash_attention": k4.flash_attention,
            "rope_flash_attention": k4.rope_flash_attention,
            "rope_flash_keys": k4.rope_flash_keys,
            "reprogramming_attention": k3.reprogramming_attention,
            "selective_scan": ss.selective_ssm, "selective_scan_h0": ss.selective_ssm_h0,
            "selective_scan_final": ss.selective_ssm_final,
            "selective_scan_bounds": ss.selective_ssm_bounds,
            "selective_scan_bwd": ss.selective_ssm_bwd,
            "grouped_matmul_gate_up": gm.GATE_UP, "grouped_matmul_down": gm.DOWN,
            "grouped_matmul_rows": gm.PLAIN, "grouped_matmul_requant": gm.REQUANT,
            "w4a8_gemm": k5.w4a8_gemm, "w8a8_quantize_grad": k1.quantize_grad_rows, "grouped_matmul_w4_gate_up": gm.GATE_UP_W4,
            "grouped_matmul_w4_down": gm.DOWN_W4, "grouped_matmul_w4_rows": gm.PLAIN_W4}


def read_counts(counters: dict) -> dict:
    return {name: c.launches for name, c in counters.items()}


def count_delta(before: dict, after: dict) -> dict:
    """The launches each counter gained from ``before`` to ``after``; only
    the counters that moved."""
    return {name: after[name] - n for name, n in before.items() if after[name] != n}


def add_counts(counters: dict, delta: dict) -> None:
    for name, n in delta.items():
        counters[name].launches += n


def _signature(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.dtype


# inputs bound into a graph by address: per layer, a pair of tensors
BOUND = ("prefix_kv", "prefix_bank")


_CAPTURE_STREAMS: dict = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream every step graph on ``device`` warms up and captures
    on, one for the process (its cuBLAS workspaces with it)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = _CAPTURE_STREAMS.get(index)
    if stream is None:
        stream = _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return stream


def step_key(arrays: dict) -> tuple:
    """The step's input signature: (name, shape, dtype) of each input array,
    and for ``prefix_kv`` and ``prefix_bank`` (per layer, a pair of tensors)
    each tensor's shape, dtype and address, since the graph reads those
    tensors where they lie."""
    key = []
    for name in sorted(arrays):
        value = arrays[name]
        if name in BOUND:
            key.append((name, tuple((*_signature(t), t.data_ptr())
                                    for layer in value for t in layer)))
        else:
            key.append((name, *_signature(value)))
    return tuple(key)


class StepGraphs:
    """``step(arrays)`` (inference mode) as one CUDA graph per ``step_key``
    on ``device``. ``graphs`` maps each key to (its graph,
    the static inputs, the static output, the launches one replay makes);
    ``capture_ms`` holds each capture's wall milliseconds (the warm-up
    apart)."""

    def __init__(self, step, device: torch.device, counters: dict | None = None):
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs capture a CUDA device's work, not {device}")
        self.step, self.device = step, device
        self.counters = launch_counters() if counters is None else counters
        self.graphs: dict[tuple, tuple] = {}
        self.capture_ms: list[float] = []
        self._pool = None

    def __len__(self) -> int:
        return len(self.graphs)

    def clear(self) -> None:
        """Drop every graph (their pool is released once nothing holds it)."""
        self.graphs.clear()
        self._pool = None

    @torch.inference_mode()
    def __call__(self, arrays: dict) -> torch.Tensor:
        return self._call(arrays)

    def _key(self, arrays: dict) -> tuple:
        return step_key(arrays)

    def _call(self, arrays: dict):
        key = self._key(arrays)
        if key not in self.graphs:
            return self._capture(key, arrays)
        graph, inputs, out, delta = self.graphs[key]
        for name, buf in inputs.items():
            buf.copy_(arrays[name], non_blocking=True)
        graph.replay()
        add_counts(self.counters, delta)
        return self._replayed(out)

    # what a subclass changes: the generators registered with each graph,
    # the call's result after a replay and after the warm-up and capture
    def _generators(self) -> tuple:
        return ()

    def _replayed(self, out):
        return out.clone()

    def _captured(self, out, static_out):
        return out

    def _capture(self, key, arrays):
        main = torch.cuda.current_stream(self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        # the static inputs, outside the pool; the prefix K/V and bank as they lie
        inputs = {name: v.clone() for name, v in arrays.items() if name not in BOUND}
        static = {**arrays, **inputs}
        side = capture_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self.step(static)  # the warm-up, counted: its kernels run
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        for g in self._generators():
            graph.register_generator_state(g)
        before = read_counts(self.counters)
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=side,
                                  capture_error_mode="thread_local"):
                static_out = self.step(static)
            delta = count_delta(before, read_counts(self.counters))
        except BaseException:
            # torch ends the capture of the generators a graph registered
            # (the device's default one and ``_generators()``) only when the
            # capture succeeds; left in capture, every later draw from them
            # raises. Each gets a fresh state at its seed and offset
            index = self.device.index
            for g in (torch.cuda.default_generators[
                    torch.cuda.current_device() if index is None else index],
                      *self._generators()):
                g.graphsafe_set_state(g.clone_state())
            raise
        finally:
            # the capture launched nothing; a failed capture may leave the
            # side stream current
            for name, n in before.items():
                self.counters[name].launches = n
            torch.cuda.set_stream(main)
        self.capture_ms.append((time.perf_counter() - t0) * 1e3)
        self.graphs[key] = (graph, inputs, static_out, delta)
        # the warm-up's output was made on the side stream; the main stream
        # waited for it above, and the side stream's next use waits for the
        # main stream, so its block is not reused while this output is read
        return self._captured(out, static_out)


class TrainGraphs(StepGraphs):
    """A whole train step, ``step(arrays) -> loss`` (forward, backward, clip
    and update of ``params``), as one CUDA graph per ``step_key`` on
    ``device``, with ``generators`` registered with each graph. Runs with
    autograd on (not in inference mode); returns the step's loss, a clone
    after a replay."""

    def __init__(self, step, device: torch.device, params, generators=(),
                 counters: dict | None = None, phase=None):
        params = list(params)

        def with_grads(arrays):  # the loss and the gradients the step made
            return step(arrays), tuple(p.grad for p in params)
        super().__init__(with_grads, device, counters)
        self.params = params
        self.generators = tuple(generators)
        self.phase = phase

    def __call__(self, arrays: dict) -> torch.Tensor:
        return self._call(arrays)

    def _key(self, arrays: dict) -> tuple:
        key = step_key(arrays)
        return key if self.phase is None else (*key, ("phase", self.phase()))

    def _generators(self) -> tuple:
        return self.generators

    def _set_grads(self, grads) -> None:
        for p, g in zip(self.params, grads):
            p.grad = g

    def _replayed(self, out):
        loss, grads = out
        self._set_grads(grads)
        return loss.clone()

    @torch.no_grad()
    def _captured(self, out, static_out):
        (loss, warm), (_, grads) = out, static_out
        for g, w in zip(grads, warm):
            if g is not None:
                g.copy_(w)
        self._set_grads(grads)
        return loss
