"""The port's int8 quantization and paged-cache bookkeeping against
mfa_tpu's: payloads byte-equal, scales to fp32 rounding (rtol 1e-6: the
two frameworks may divide absmax by 127 differently), and the
map/release/append semantics on the shared block table and merged pool."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfa_tpu.cache import paged_cache as jcache
from mfa_tpu.kernels.quant import quantize_rows as jax_quantize
from mfa_tpu.models import llama as jllama
from mfa_tpu_torch.cache import paged_cache as tcache
from mfa_tpu_torch.kernels.quant import dequantize_rows, quantize_rows
from mfa_tpu_torch.models import llama as tllama
from tests.jax_maps import release_jax_code  # noqa: F401


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_int8_payload_byte_equal(dtype):
    rng = np.random.RandomState(0)
    x = rng.standard_normal((3, 17, 64)).astype(np.float32) * 3.0
    x[0, 4] = 0.0  # an all-zero row keeps scale 1
    jx = jnp.asarray(x) if dtype == np.float32 else jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x)
    if dtype != np.float32:
        tx = tx.to(torch.bfloat16)
    jq, js = jax_quantize(jx, "int8")
    tq, ts = quantize_rows(tx, "int8")
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    assert ts[0, 4].item() == 1.0
    back = dequantize_rows(tq, ts).numpy()
    np.testing.assert_allclose(back, x if dtype == np.float32 else
                               tx.float().numpy(), atol=ts.max().item())


def test_round_half_to_even_like_jnp():
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]])
    q, s = quantize_rows(x, "int8")
    assert s.item() == 1.0
    assert q.tolist() == [[0, 2, 2, 0, -2, 127]]


def test_fp8_and_int4_raise_for_now():
    """fp8 and int4 are ported (tests/test_torch_kv_formats.py); what is
    still refused is a format the package does not know."""
    for qd in ("int2", "e5m2"):
        with pytest.raises(ValueError):
            quantize_rows(torch.zeros(2, 8), qd)


def test_map_release_match_jax():
    jc = jcache.create_stacked_cache(2, 8, 4, 2, 128, 3, 4)
    tc = tcache.create_stacked_cache(2, 8, 4, 2, 128, 3, 4, dtype=torch.float32,
                                     device="cpu")
    assert tc.num_pages == jc.num_pages == 8 and tc.k_pages.shape == jc.k_pages.shape
    jc = jcache.map_pages(jc, [0, 0, 2], [0, 1, 3], [5, 6, 7])
    same = tcache.map_pages(tc, [0, 0, 2], [0, 1, 3], [5, 6, 7])
    assert same is tc  # in place
    np.testing.assert_array_equal(tc.block_tables.numpy(), np.asarray(jc.block_tables))
    tc.lengths[:] = torch.tensor([3, 1, 2], dtype=torch.int32)
    jc = dataclasses.replace(jc, lengths=jnp.asarray([3, 1, 2], jnp.int32))
    jc = jcache.release_slots(jc, [0, 2])
    tcache.release_slots(tc, [0, 2])
    np.testing.assert_array_equal(tc.block_tables.numpy(), np.asarray(jc.block_tables))
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


def test_page_allocator_reserves_null_page():
    a = tcache.PageAllocator(6)
    assert a.free_pages == 5
    got = a.alloc(3)
    assert got == [1, 2, 3]
    with pytest.raises(MemoryError):
        a.alloc(3)
    a.free(got + [0])
    assert a.free_pages == 5


@pytest.mark.parametrize("quant", [None, "int8"])
def test_append_all_layers_matches_jax(quant):
    L, P, page, hkv, d, R = 2, 6, 4, 2, 128, 3
    rng = np.random.RandomState(1)
    rows = rng.standard_normal((L, hkv, R, d)).astype(np.float32)
    page_ids = np.array([2, 5, 1], np.int32)
    offs = np.array([0, 3, 2], np.int32)
    jc = jcache.create_stacked_cache(L, P, page, hkv, d, 3, 2,
                                     dtype=jnp.float32, quant_dtype=quant)
    tc = tcache.create_stacked_cache(L, P, page, hkv, d, 3, 2,
                                     dtype=torch.float32, quant_dtype=quant,
                                     device="cpu")
    if quant:
        jq, js = jax_quantize(jnp.asarray(rows), quant)
        tq, ts = quantize_rows(torch.from_numpy(rows), quant)
        jc = jllama._append_all_layers(jc, jq, js, jq, js,
                                       jnp.asarray(page_ids), jnp.asarray(offs))
        tllama._append_all_layers(tc, tq, ts, tq, ts,
                                  torch.from_numpy(page_ids),
                                  torch.from_numpy(offs))
        np.testing.assert_allclose(tc.k_scales.numpy(), np.asarray(jc.k_scales),
                                   rtol=1e-6)
    else:
        jc = jllama._append_all_layers(jc, jnp.asarray(rows), None,
                                       jnp.asarray(rows), None,
                                       jnp.asarray(page_ids), jnp.asarray(offs))
        tllama._append_all_layers(tc, torch.from_numpy(rows), None,
                                  torch.from_numpy(rows), None,
                                  torch.from_numpy(page_ids),
                                  torch.from_numpy(offs))
    np.testing.assert_array_equal(tc.k_pages.numpy(), np.asarray(jc.k_pages))
    np.testing.assert_array_equal(tc.v_pages.numpy(), np.asarray(jc.v_pages))
    # layer l's logical page p is physical l * P + p
    assert tc.k_pages[:, P + 5, 3].abs().sum() > 0
