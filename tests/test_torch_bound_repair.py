"""The port's zero-shift prefill engines (mfa_tpu_torch/kernels/prefill.py,
the plain versions on the CPU) against mfa_tpu's prefill_attention in
Pallas interpret mode and the fp32 oracle: the flagged engine with its
repair (the default), the bound engine ("prepass", "unchecked") and the
probe modes, on inputs that poison the zero-shift sums (overflow,
near-flush) and on benign ones. Mirrors tests/test_bound_repair.py.

Tolerances: 3e-3 on adversarial inputs (scores of order 1e5: the repaired
rows come from a classic softmax over them, in fp32 on both sides), 1e-4
on benign fp32 inputs (two fp32 implementations, summation order only).
The port's flags are per 64-row tile and JAX's per its own q block, so
the tests compare whether blocks were flagged, not the arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.kernels.prefill import prefill_attention as jax_prefill
from mfa_tpu_torch.kernels import prefill
from mfa_tpu_torch.kernels.prefill import prefill_attention
from mfa_tpu_torch.ref.oracle import attention_ref
from tests.jax_maps import release_jax_code  # noqa: F401

ADV, BENIGN = 3e-3, 1e-4


def _qkv(seed, b, hq, hkv, sq, sk, d, std=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.standard_normal(s) * std).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


def _port(q, k, v, **kw):
    out = prefill_attention(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (q, k, v)),
                            **kw)
    if isinstance(out, tuple):
        return tuple(o.float().numpy() for o in out)
    return out.float().numpy()


def _jax(q, k, v, **kw):
    out = jax_prefill(*(jnp.asarray(x) for x in (q, k, v)), **kw)
    if isinstance(out, tuple):
        return tuple(np.asarray(o, np.float32) for o in out)
    return np.asarray(out, np.float32)


def _oracle(q, k, v, **kw):
    """attention_ref on the [b, h, s, d] layout, in fp32."""
    t = [torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, 1, 2))).float()
         for x in (q, k, v)]
    return np.swapaxes(attention_ref(*t, **kw).numpy(), 1, 2)


def _max_err(a, b):
    return float(np.max(np.abs(np.nan_to_num(a, nan=1e9) - b)))


def test_repair_fires_and_fixes_overflow():
    # std 1e3: zero-shift sums overflow to inf and whole rows flush to 0
    q, k, v = _qkv(0, 1, 2, 2, 256, 256, 128, std=1e3)
    out = _port(q, k, v, causal=True)
    ref = _oracle(q, k, v, causal=True)
    assert _max_err(out, ref) < ADV
    assert _max_err(out, _jax(q, k, v, causal=True)) < ADV
    raw = _port(q, k, v, causal=True, bound_softmax="unchecked")
    assert _max_err(raw, ref) > 1e-2, "unchecked agreed: the inputs did not poison"


def test_repair_near_flush_weight_loss():
    # every score near -18100: all winners flush, l falls below _L_MIN
    q, k, v = _qkv(1, 1, 2, 2, 128, 128, 128)
    q, k = q + 40.0, k - 40.0
    out = _port(q, k, v, causal=True)
    ref = _oracle(q, k, v, causal=True)
    assert _max_err(out, ref) < ADV
    assert _max_err(out, _jax(q, k, v, causal=True)) < ADV
    _, flags = _port(q, k, v, causal=True, bound_softmax="flag_debug")
    assert flags.sum() == flags.size  # every tile flagged


def test_repair_mixed_batch_and_lse():
    qa, ka, va = _qkv(2, 1, 2, 2, 320, 320, 128, std=1e3)
    qb, kb, vb = _qkv(3, 1, 2, 2, 320, 320, 128)
    q, k, v = (np.concatenate(p) for p in ((qa, qb), (ka, kb), (va, vb)))
    out, lse, flags = _port(q, k, v, causal=True, return_lse=True,
                            bound_softmax="flag_debug")
    assert flags[0].sum() > 0 and flags[1].sum() == 0  # only the poisoned element
    assert _max_err(out, _oracle(q, k, v, causal=True)) < ADV
    s = torch.einsum("bhqd,bhkd->bhqk", torch.from_numpy(q), torch.from_numpy(k)) \
        / np.sqrt(128.0)
    s = s.masked_fill(torch.arange(320)[None, :] > torch.arange(320)[:, None],
                      float("-inf"))
    ref_lse = torch.logsumexp(s, -1).numpy()
    rel = np.abs(lse - ref_lse) / np.maximum(np.abs(ref_lse), 1.0)
    assert rel.max() < 1e-3
    _, jlse = _jax(q, k, v, causal=True, return_lse=True)
    assert (np.abs(lse - jlse) / np.maximum(np.abs(jlse), 1.0)).max() < 1e-3


def test_repair_window_adversarial():
    # the JAX test's window case without its sinks (not ported)
    q, k, v = _qkv(4, 1, 2, 2, 384, 384, 128, std=300.0)
    out = _port(q, k, v, causal=True, window_size=(127, 0))
    assert _max_err(out, _oracle(q, k, v, causal=True, window_size=(127, 0))) < ADV
    assert _max_err(out, _jax(q, k, v, causal=True, window_size=(127, 0))) < ADV


def test_repair_window_sinks_adversarial():
    # the JAX test's window case with its sinks: the sink tiles are scanned
    # and repaired with the band; the classic engine on the same input
    q, k, v = _qkv(4, 1, 2, 2, 384, 384, 128, std=300.0)
    kw = dict(causal=True, window_size=(127, 0), sink_tokens=4)
    out = _port(q, k, v, **kw)
    ref = _port(q, k, v, bound_softmax=False, **kw)
    assert _max_err(out, ref) < ADV
    assert _max_err(out, _jax(q, k, v, **kw)) < ADV
    assert _max_err(out, _port(q, k, v, causal=True, window_size=(127, 0))) > 1e-2


def test_repair_ragged_tail():
    q, k, v = _qkv(5, 1, 2, 2, 200, 173, 128, std=1e3)
    out = _port(q, k, v, causal=True)
    assert _max_err(out, _oracle(q, k, v, causal=True)) < ADV
    assert _max_err(out, _jax(q, k, v, causal=True)) < ADV


@pytest.mark.parametrize("mode", [True, "prepass", "unchecked", False, "flag_only",
                                  "flag_presence"])
def test_modes_agree_on_benign(mode):
    q, k, v = _qkv(6, 2, 4, 2, 256, 256, 128)
    out = _port(q, k, v, causal=True, bound_softmax=mode)
    assert _max_err(out, _oracle(q, k, v, causal=True)) < BENIGN
    assert _max_err(out, _jax(q, k, v, causal=True, bound_softmax=mode)) < BENIGN


def test_modes_agree_on_benign_bf16():
    # the JAX test's inputs: bf16 at d 64 (the default takes the bound
    # engine there); p is cast to bf16 before P.V on both sides
    q, k, v = (x.astype(jnp.bfloat16) for x in _qkv(6, 2, 4, 2, 256, 256, 64))
    ref = _oracle(*(np.asarray(x, np.float32) for x in (q, k, v)), causal=True)
    for mode in (True, "prepass", "unchecked", False):
        out = prefill_attention(*(torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
                                  for x in (q, k, v)), causal=True, bound_softmax=mode)
        assert out.dtype == torch.bfloat16
        assert _max_err(out.float().numpy(), ref) < 2e-2, mode
        jo = _jax(q, k, v, causal=True, bound_softmax=mode)
        assert _max_err(out.float().numpy(), jo) < 2e-2, mode


def test_prepass_mode_still_guards():
    q, k, v = _qkv(7, 1, 2, 2, 256, 256, 128, std=1e3)
    out = _port(q, k, v, causal=True, bound_softmax="prepass")
    assert _max_err(out, _oracle(q, k, v, causal=True)) < ADV
    assert _max_err(out, _jax(q, k, v, causal=True, bound_softmax="prepass")) < ADV


def test_narrow_head_dim_falls_back_safely():
    # head_dim % 128 != 0: the default takes the bound engine ("prepass")
    q, k, v = _qkv(8, 1, 2, 2, 256, 256, 64, std=1e3)
    assert prefill.select_engine(None, torch.float32, 64, 0.0) == ("bound", "prepass")
    out = _port(q, k, v, causal=True)
    assert _max_err(out, _oracle(q, k, v, causal=True)) < ADV
    assert _max_err(out, _jax(q, k, v, causal=True)) < ADV


def test_flag_rate_zero_on_benign():
    q, k, v = _qkv(5, 2, 2, 2, 256, 256, 128)
    out, flags = _port(q, k, v, causal=True, bound_softmax="flag_debug")
    assert flags.shape == (2, 2, 4) and flags.sum() == 0
    _, jflags = _jax(q, k, v, causal=True, bound_softmax="flag_debug")
    assert jflags.sum() == 0
    assert _max_err(out, _oracle(q, k, v, causal=True)) < BENIGN


def test_flag_rate_zero_on_empty_band_rows():
    # a left window past a shorter kv sequence: rows 28.. have an empty band
    # (l == 0 legitimately) and must not flag; their O is 0 and LSE -inf
    q, k, v = _qkv(9, 1, 2, 2, 128, 20, 128)
    out, lse, flags = _port(q, k, v, window_size=(8, -1), return_lse=True,
                            bound_softmax="flag_debug")
    assert flags.sum() == 0
    dead = np.arange(128) > 19 + 8
    assert np.all(out[:, :, dead] == 0) and np.all(np.isneginf(lse[:, :, dead]))
    assert _max_err(out, _oracle(q, k, v, window_size=(8, -1))) < BENIGN
    assert _max_err(out, _jax(q, k, v, window_size=(8, -1))) < BENIGN


def test_flag_rate_nonzero_on_adversarial():
    q, k, v = _qkv(7, 1, 2, 2, 256, 256, 128, std=1e3)
    out, flags = _port(q, k, v, causal=True, bound_softmax="flag_debug")
    assert flags.sum() > 0
    _, jflags = _jax(q, k, v, causal=True, bound_softmax="flag_debug")
    assert jflags.sum() > 0
    assert _max_err(out, _oracle(q, k, v, causal=True)) < ADV
    # flag_only keeps the poisoned zero-shift rows: far from the oracle
    raw = _port(q, k, v, causal=True, bound_softmax="flag_only")
    assert _max_err(raw, _oracle(q, k, v, causal=True)) > 1e-2


def test_risky_bits_follow_the_norm_bound():
    # per 64-row tile: |q|max * |k|max * scale * log2 e > 100
    q, k, _ = _qkv(10, 1, 4, 2, 200, 150, 64)
    q[0, 1, 70] *= 30.0  # one loud row in tile 1 of head 1
    c = 64 ** -0.5 * prefill._LOG2E
    bits = prefill._risky_bits(torch.from_numpy(q), torch.from_numpy(k), c).numpy()
    qn = np.linalg.norm(q, axis=-1)
    kn = np.linalg.norm(k, axis=-1).max(-1).repeat(2, axis=1)
    want = np.zeros((1, 4, 4), bool)
    for t in range(4):
        want[:, :, t] = qn[:, :, t * 64:(t + 1) * 64].max(-1) * kn * c > 100.0
    np.testing.assert_array_equal(bits, want.astype(np.int32))
    assert bits[0, 1, 1] == 1 and bits.sum() == 1


def _fp16_fault_inputs(kind):
    """b1 h2 s256 d128 fp16: 'overflow' gives every row a natural logit of
    about 21 against key 0; 'flush' puts every logit near -16."""
    rng = np.random.RandomState(11)
    q = 1.0 + 0.05 * rng.standard_normal((1, 2, 256, 128))
    k = 0.05 * rng.standard_normal((1, 2, 256, 128))
    v = rng.standard_normal((1, 2, 256, 128))
    c = 128 ** 0.5 / 128  # q . (c * ones) * 128^-0.5 = 1 for q = ones
    if kind == "overflow":
        k[:, :, 0] += 21.0 * c
    else:
        k -= 16.0 * c
    return [x.astype(np.float16) for x in (q, k, v)]


@pytest.mark.parametrize("kind", ["overflow", "flush"])
def test_fp16_default_takes_the_classic_engine(kind):
    # mfa_tpu's default zero-shift engine casts the unshifted p to fp16,
    # which leaves its range: non-finite or far off the oracle. The port's
    # default sends fp16 to kernel 1 (classic) and stays exact.
    q, k, v = _fp16_fault_inputs(kind)
    ref = _oracle(*(x.astype(np.float32) for x in (q, k, v)), causal=True)
    jo = _jax(q, k, v, causal=True)
    assert not np.isfinite(jo).all() or _max_err(jo, ref) > 2e-2
    out = prefill_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True)
    assert out.dtype == torch.float16
    assert _max_err(out.float().numpy(), ref) < 2e-3
    with pytest.raises(NotImplementedError, match="fp16"):
        prefill_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True,
                          bound_softmax="prepass")


def test_engine_selection():
    sel = prefill.select_engine
    assert sel(None, torch.bfloat16, 128, 0.0) == ("flagged", True)
    assert sel(True, torch.bfloat16, 256, 0.0) == ("flagged", True)
    assert sel("flag_debug", torch.bfloat16, 128, 0.0) == ("flagged", "flag_debug")
    assert sel(None, torch.bfloat16, 64, 0.0) == ("bound", "prepass")
    assert sel("unchecked", torch.bfloat16, 128, 0.0) == ("bound", "unchecked")
    assert sel(False, torch.bfloat16, 128, 0.0) == ("classic", False)
    assert sel(None, torch.bfloat16, 128, 30.0) == ("classic", False)  # softcap
    assert sel(None, torch.float16, 128, 0.0) == ("classic", False)
    with pytest.raises(NotImplementedError, match="fp16"):
        sel("unchecked", torch.float16, 128, 0.0)
    with pytest.raises(ValueError):
        sel("fast", torch.bfloat16, 128, 0.0)
