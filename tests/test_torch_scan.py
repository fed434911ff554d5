"""The selective scan's forward decomposition and the mixer's gated serving
form, on the CPU.

  1. ``selective_ssm_split``, a PyTorch mirror of the forward kernel's
     order of work (csrc/selective_scan.cu: log2(e) folded into A, one 2^x
     a (t, n), each group's 4 states summed in order, then the groups
     pairwise), against the plain version and the Pallas kernels in
     interpret mode (``_ssm_pallas``, ``_ssm_pallas_h0``,
     ``_ssm_pallas_with_bounds``) and JAX's prefill form, at N 4 / 8 / 16,
     L 37 and L 1, without h0 and with a batch-1 and a batch-B h0;
  2. ``selective_ssm_gated_plain`` (what a CPU tensor takes for the gated
     form) against the mixer's composition before the gated form existed,
     bit for bit, on strided views of x_proj- and in_proj-shaped buffers;
  3. ``MambaBlock`` against JAX's ``MambaBlock`` on copied weights, through
     the gated form (no gradient) and through the training path; which
     path the block takes.

Tolerances: f32 differs from the Pallas kernels and the plain loop in
summation order and in exp against 2^x of a rounded exponent (1e-5, as
tests/test_torch_mamba.py); the block at tests/test_torch_mamba.py's
(1e-5 f32, 3e-2 bf16 storage).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from medtsllm_tpu.models.llm import mamba as jmamba
from medtsllm_tpu.models.llm.loader import _mamba_presets
from medtsllm_tpu.ops.pallas import selective_scan as jss
from medtsllm_tpu_torch.models.llm import mamba as tmamba
from medtsllm_tpu_torch.models.llm.config import MAMBA_PRESETS
from medtsllm_tpu_torch.ops.kernels import selective_scan as kss
from medtsllm_tpu_torch.weights import from_flax

torch.set_num_threads(1)

_ORDER = ("dt", "A_T", "Bs", "Cs", "xs", "D")
_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


def _close(got, want, tol):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


def _inputs(seed, B, L, E, N, h0_rows):
    """The raw interface's operands (A scaled by N as the served A_log's
    exp(log(1..N)) is) and h0, from numpy."""
    rng = np.random.default_rng(seed)

    def mk(*s):
        return rng.standard_normal(s).astype(np.float32)
    a = dict(dt=np.abs(mk(B, L, E)) * 0.1, A_T=-np.abs(mk(N, E)) * N, Bs=mk(B, L, N),
             Cs=mk(B, L, N), xs=mk(B, L, E), D=mk(E))
    h0 = mk(h0_rows, N, E) if h0_rows else None
    return a, h0


# --------------------------------------------------------------------------
# 1. the forward kernel's decomposition
# --------------------------------------------------------------------------

@pytest.mark.parametrize("h0_rows", [0, 1, 2])
@pytest.mark.parametrize("L", [37, 1])
@pytest.mark.parametrize("N", [4, 8, 16])
def test_split_matches_plain_and_pallas(N, L, h0_rows):
    """y of the split against the plain scan and K7 / K8 in interpret mode;
    L 37 is no multiple of the kernels' 16-token tile."""
    B, E = 2, 128
    a, h0 = _inputs(N * 10 + L + h0_rows, B, L, E, N, h0_rows)
    ta = [torch.from_numpy(a[k]) for k in _ORDER]
    th0 = None if h0 is None else torch.from_numpy(h0)
    ja = [jnp.asarray(a[k]) for k in _ORDER]
    y, h_final, hb = kss.selective_ssm_split(*ta, th0)
    assert y.shape == (B, L, E) and h_final.shape == (B, N, E) and hb is None
    y0, h0_final = kss.selective_ssm_final_plain(*ta, th0)
    _close(y, y0, 1e-5)
    _close(h_final, h0_final, 1e-5)
    if h0 is None:
        want = jss._ssm_pallas(*ja, chunk=16, block_e=128, interpret=True)
    else:
        want = jss._ssm_pallas_h0(*ja, jnp.asarray(h0), chunk=16, block_e=128,
                                  interpret=True)
    _close(y, want, 1e-5)


@pytest.mark.parametrize("h0_rows", [0, 1, 2])
@pytest.mark.parametrize("N,chunk", [(4, 8), (16, 16)])
def test_split_records_chunk_states_as_k9(N, chunk, h0_rows):
    """The split's chunk-start states (K9's hb) against
    ``_ssm_pallas_with_bounds`` in interpret mode and the plain version;
    its final state against JAX's prefill form ``selective_ssm_final``."""
    B, L, E = 2, 37, 128
    a, h0 = _inputs(chunk + h0_rows, B, L, E, N, h0_rows)
    ta = [torch.from_numpy(a[k]) for k in _ORDER]
    th0 = None if h0 is None else torch.from_numpy(h0)
    ja = [jnp.asarray(a[k]) for k in _ORDER]
    jh0 = None if h0 is None else jnp.asarray(h0)
    y, h_final, hb = kss.selective_ssm_split(*ta, th0, chunk)
    assert hb.shape == (B, -(-L // chunk), N, E)
    y_j, hb_j = jss._ssm_pallas_with_bounds(*ja, chunk=chunk, block_e=128, interpret=True,
                                            h0=jh0)
    _close(y, y_j, 1e-5)
    _close(hb, hb_j, 1e-5)
    y0, hb0 = kss.selective_ssm_bounds_plain(*ta, th0, chunk)
    _close(hb, hb0, 1e-5)
    _, h_j = jss.selective_ssm_final(*ja, h0=jh0)
    _close(h_final, h_j, 1e-5)


def test_split_groups_follow_the_kernels_rule():
    """N / 4 groups a channel, 4 states each, at every instance of N."""
    assert [kss.fwd_groups(n) for n in kss.STATE_SIZES] == [1, 2, 4]
    assert all(kss.fwd_groups(n) * kss.FWD_STATES_PER_THREAD == n for n in kss.STATE_SIZES)


# --------------------------------------------------------------------------
# 2. the gated form's plain version
# --------------------------------------------------------------------------

def _mixer_views(seed, B, L, E, N, R, dtype):
    """dt_raw, A_log, Bs, Cs, xs, D, z as the mixer holds them: Bs / Cs
    column slices of an x_proj-shaped [B, L, R + 2N] buffer, z the second
    half of an in_proj-shaped [B, L, 2E] one; A_log and D at the dtype."""
    rng = np.random.default_rng(seed)

    def mk(*s, scale=1.0):
        return torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32)).to(dtype)
    xdbc = mk(B, L, R + 2 * N)
    xz = mk(B, L, 2 * E)
    A_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32)).expand(E, N)
    A_log = (A_log + mk(E, N, scale=0.1).float()).to(dtype).contiguous()
    dt_raw = mk(B, L, E, scale=2.0) - 3.0  # softplus inputs on both sides of 0
    dt_raw[0, 0, :4] = torch.tensor([25.0, 20.5, -30.0, 0.0]).to(dtype)  # past 20
    return (dt_raw, A_log, xdbc[..., R:R + N], xdbc[..., R + N:], mk(B, L, E), mk(E),
            xz[..., E:])


def _mixer_before(dt_raw, A_log, Bs, Cs, xs, D, z, h0, final):
    """The mixer's lines around the scan before the gated form
    (models/llm/mamba.py), on the scan's CPU wrappers."""
    dt = F.softplus(dt_raw.float())
    A_T = (-torch.exp(A_log.float())).T.contiguous()
    args = (dt, A_T, Bs.float().contiguous(), Cs.float().contiguous(),
            xs.float().contiguous(), D.float())
    if final:
        y, h_final = kss.selective_ssm_final(*args, h0)
    elif h0 is not None:
        y, h_final = kss.selective_ssm_h0(*args, h0), None
    else:
        y, h_final = kss.selective_ssm(*args), None
    return y.to(z.dtype) * F.silu(z), h_final


@pytest.mark.parametrize("h0_rows,final", [(0, False), (1, False), (3, False), (0, True),
                                           (1, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_plain_is_the_mixer_composition(dtype, h0_rows, final):
    """Bit for bit, in f32 and in bf16, with the strided views the mixer
    passes; the wrapper takes the plain version for CPU tensors."""
    B, L, E, N, R = 3, 19, 64, 8, 5
    ops = _mixer_views(h0_rows + 7 * final, B, L, E, N, R, dtype)
    assert not ops[2].is_contiguous() and not ops[6].is_contiguous()
    h0 = (torch.from_numpy(np.random.default_rng(1).standard_normal((h0_rows, N, E))
                           .astype(np.float32)) if h0_rows else None)
    want, want_h = _mixer_before(*ops, h0, final)
    for fn in (kss.selective_ssm_gated_plain, kss.selective_ssm_gated):
        got = fn(*ops, h0, final)
        got, got_h = got if final else (got, None)
        assert got.dtype == dtype and got.shape == (B, L, E)
        assert torch.equal(got, want)
        if final:
            assert torch.equal(got_h, want_h)


def test_gated_form_refuses_gradients():
    ops = _mixer_views(0, 2, 5, 16, 4, 3, torch.float32)
    dt_raw = ops[0].clone().requires_grad_()
    with pytest.raises(ValueError, match="serving form"):
        kss.selective_ssm_gated(dt_raw, *ops[1:])
    with torch.no_grad():
        kss.selective_ssm_gated(dt_raw, *ops[1:])


# --------------------------------------------------------------------------
# 3. the block
# --------------------------------------------------------------------------

def _block_pair(storage, seed=0):
    jc, tc = _mamba_presets()["mamba-tiny"], MAMBA_PRESETS["mamba-tiny"]
    jdt = None if storage == "float32" else JDT[storage]
    jb = jmamba.MambaBlock(jc, dtype=jdt, param_dtype=JDT[storage])
    x = jnp.asarray(np.random.default_rng(seed).standard_normal((2, 11, jc.d_model)),
                    jnp.float32)
    params = jax.jit(lambda k, a: jb.init(k, a))(jax.random.PRNGKey(seed), x)["params"]
    rng = np.random.default_rng(seed + 1)

    def fix(leaf):  # non-trivial conv bias and D, at the storage dtype
        if leaf.ndim == 1 and leaf.shape[0] != jc.d_model:
            leaf = jnp.asarray(rng.uniform(-0.5, 0.5, leaf.shape), jnp.float32)
        return leaf.astype(JDT[storage])
    params = jax.tree.map(fix, params)
    tb = tmamba.MambaBlock(tc, None if storage == "float32" else TDT[storage])
    tb.to(TDT[storage]).load_state_dict(from_flax(jax.device_get(params)))
    return jb, params, tb, x


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_block_matches_jax_block(storage, grad):
    """The forward, the prefill of a 5-token head (out, conv tail, h) and
    the forward from that state, against JAX's MambaBlock: without a
    gradient through the gated form, with one through the training path."""
    jb, p, tb, x = _block_pair(storage)
    tb.requires_grad_(grad)
    tol = _TOL[storage]
    tx = torch.from_numpy(np.array(x))
    P = 5
    run = jax.jit(lambda p, a: jb.apply({"params": p}, a))
    pre = jax.jit(lambda p, a: jb.apply({"params": p}, a, return_state=True))
    suf = jax.jit(lambda p, a, st: jb.apply({"params": p}, a, prefix_state=st))
    with torch.set_grad_enabled(grad):
        _close(tb(tx), run(p, x), tol)
        out_j, (tail_j, h_j) = pre(p, x[:1, :P])
        out_t, (tail_t, h_t) = tb(tx[:1, :P], return_state=True)
        for got, want in ((out_t, out_j), (tail_t, tail_j), (h_t, h_j)):
            _close(got, want, tol)
        _close(tb(tx[:, P:], prefix_state=(tail_t, h_t)),
               suf(p, x[:, P:], (tail_j, h_j)), tol)


def test_block_serves_through_the_gated_form(monkeypatch):
    """No gradient: every form (plain, from a cached state, the prefill)
    goes through ``selective_ssm_gated``; with one, none does."""
    _, _, tb, x = _block_pair("float32")
    calls = []
    gated = kss.selective_ssm_gated

    def spy(*args):
        calls.append((args[7] is not None, args[8]))
        return gated(*args)
    monkeypatch.setattr(tmamba, "selective_ssm_gated", spy)
    tx = torch.from_numpy(np.array(x))
    with torch.no_grad():
        _, state = tb(tx[:1, :5], return_state=True)
        tb(tx[:, 5:], prefix_state=state)
        tb(tx)
    assert calls == [(False, True), (True, False), (False, False)]
    tb(tx).sum().backward()
    assert len(calls) == 3 and tb.dt_proj.weight.grad is not None
