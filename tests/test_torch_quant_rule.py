"""The port's KV and weight quantizers against mfa_tpu's, byte for byte.

mfa_tpu computes a row's scale absmax / qmax. Eagerly that is a true
division; inside jax.jit, XLA turns the division by the constant into
absmax * f32(1 / qmax), which differs by an ulp in about 4% of int8
scales and 58% of fp8 and int4 ones on N(0, 1) rows (and moves the
payloads of the values on a rounding edge). Each quantizer of the port
takes the rule of its mfa_tpu caller (kernels/quant.py:scale_of):

- jitted there: the engine's KV writes (`paged_cache.payload_rows` in
  prefill, chunk, decode and verify steps: mfa_tpu's `_store_rows` inside
  its jitted steps), `append_token`, and `wquant.quantize_weight`
  (`_quantize_body`);
- eager there: `quantize_rows` and `write_prompt`.

Inputs: 8 x 4096 x 128 N(0, 1) rows for the row quantizer, 4096 x 4096
N(0, 0.02) weights for the weight quantizer, from numpy seeds. Each case
also shows that the other rule misses mfa_tpu's scales on these inputs, so
the equality is not one both rules would pass.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.cache import paged_cache as jc
from mfa_tpu.kernels import quant as jq
from mfa_tpu.models import llama as jl
from mfa_tpu.models import wquant as jw
from mfa_tpu_torch.cache import paged_cache as tc
from mfa_tpu_torch.kernels import quant as tq
from mfa_tpu_torch.models import wquant as tw
from tests.jax_maps import release_jax_code  # noqa: F401
from tests.test_torch_layer_cache import _assert_same_cache

FORMATS = ("int8", "fp8", "int4")


@functools.lru_cache(maxsize=1)
def _rows():
    return np.random.default_rng(0).standard_normal((8, 4096, 128)).astype(np.float32)


def _bytes(t):
    """A payload's bytes as numpy int8 (fp8 through its bits)."""
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int8) if t.dtype == tq.FP8 else t).numpy()
    return np.asarray(t.view(jnp.int8) if t.dtype == jnp.float8_e4m3fn else t)


def _assert_rows_equal(got, want):
    (gp, gs), (wp, ws) = got, want
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(_bytes(gp), _bytes(wp))


def _scales_off(x, fmt, reciprocal, want_scales):
    """How many scales of the rule `reciprocal` differ from mfa_tpu's."""
    _, s = tq.quantize_rows(torch.from_numpy(x), fmt, reciprocal)
    return int((s.numpy() != np.asarray(want_scales)).sum())


@pytest.mark.parametrize("jitted", [True, False], ids=["jitted", "eager"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_quantize_rows_takes_the_callers_rule(fmt, jitted):
    """quantize_rows(reciprocal=jitted) equals jax.jit(quantize_rows) or
    eager quantize_rows of mfa_tpu: payload bytes and scales."""
    x = _rows()
    fn = jax.jit(jq.quantize_rows, static_argnums=1) if jitted else jq.quantize_rows
    want = fn(jnp.asarray(x), fmt)
    _assert_rows_equal(tq.quantize_rows(torch.from_numpy(x), fmt, jitted), want)
    off = _scales_off(x, fmt, not jitted, want[1])
    print(f"{fmt}, mfa_tpu {'jitted' if jitted else 'eager'}: the other rule misses "
          f"{off} of {want[1].size} scales")
    assert off > 100


@pytest.mark.parametrize("fmt", FORMATS)
def test_engine_writes_take_the_jitted_rule(fmt):
    """payload_rows, the engine's KV writer (its default rule), equals
    mfa_tpu's _store_rows as its jitted steps compile it."""
    x = _rows()
    want = jax.jit(jl._store_rows, static_argnums=(0, 1))(fmt, jnp.int8, jnp.asarray(x))
    got = tc.payload_rows(fmt, torch.int8, torch.from_numpy(x))
    _assert_rows_equal(got, want)


def _caches(fmt, **kw):
    kw = dict(num_kv_heads=8, head_dim=128, quant_dtype=fmt, **kw)
    return (jc.create_cache(dtype=jnp.float32, **kw),
            tc.create_cache(dtype=torch.float32, device="cpu", **kw))


@pytest.mark.parametrize("fmt", FORMATS)
def test_append_token_takes_the_jitted_rule(fmt):
    """64 sequences, 8 appended tokens each (4096 K and V rows of 8 heads):
    the port's append_token writes mfa_tpu's jitted append_token's payloads
    and scales."""
    n, steps, page = 64, 8, 16
    j, t = _caches(fmt, num_pages=n + 1, page_size=page, max_seqs=n, pages_per_seq=1)
    for s in range(n):
        j = jc.map_page(j, s, 0, s + 1)
        tc.map_page(t, s, 0, s + 1)
    rng = np.random.default_rng(1)
    slots = np.arange(n, dtype=np.int32)
    for _ in range(steps):
        nk, nv = (rng.standard_normal((n, 8, 128)).astype(np.float32) for _ in range(2))
        j = jc.append_token(j, jnp.asarray(slots), jnp.asarray(nk), jnp.asarray(nv))
        tc.append_token(t, torch.from_numpy(slots), torch.from_numpy(nk),
                        torch.from_numpy(nv))
    _assert_same_cache(j, t, fmt, 128)


@pytest.mark.parametrize("fmt", FORMATS)
def test_write_prompt_takes_the_eager_rule(fmt):
    """A 4096-token prompt of 8 heads into pages of 64: the port's
    write_prompt writes mfa_tpu's (eager) write_prompt's payloads and
    scales."""
    L, page = 4096, 64
    j, t = _caches(fmt, num_pages=L // page + 1, page_size=page, max_seqs=1,
                   pages_per_seq=L // page)
    rng = np.random.default_rng(2)
    k, v = (rng.standard_normal((L, 8, 128)).astype(np.float32) for _ in range(2))
    pages = list(range(1, L // page + 1))
    j = jc.write_prompt(j, 0, pages, jnp.asarray(k), jnp.asarray(v))
    tc.write_prompt(t, 0, pages, torch.from_numpy(k), torch.from_numpy(v))
    _assert_same_cache(j, t, fmt, 128)


@pytest.mark.parametrize("axis", [-2, -1])
def test_quantize_weight_takes_the_jitted_rule(axis):
    """quantize_weight equals mfa_tpu's (its body jitted) on a 4096 x 4096
    N(0, 0.02) weight, int8 payload and fp32 scales; true division would
    miss some of its scales."""
    w = (np.random.default_rng(3).standard_normal((4096, 4096)) * 0.02).astype(np.float32)
    got = tw.quantize_weight(torch.from_numpy(w), axis=axis)
    want = jw.quantize_weight(jnp.asarray(w), axis=axis)
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.qw.numpy(), np.asarray(want.qw))
    absmax = torch.from_numpy(np.abs(w).max(axis=axis))
    off = int((tq.scale_of(absmax, 127.0).numpy() != np.asarray(want.scale)).sum())
    print(f"weight axis {axis}: true division misses {off} of {want.scale.size} scales")
    assert off > 10
