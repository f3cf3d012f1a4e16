"""The port's save_params / load_params (utils/checkpoint.py) keep mfa_tpu's
contract: a bit-exact round trip of the params tree (bf16 leaves stored by
their bit pattern, fp32 norms, Qwen2's biases, int8 QWeight leaves with
their scales and axis), leaf paths stored beside the leaves, and
ValueError when the saved structure is not `like`'s."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from mfa_tpu_torch.models import llama
from mfa_tpu_torch.models.wquant import QWeight, quantize_params
from mfa_tpu_torch.utils.checkpoint import _flatten, load_params, save_params

CFG = llama.LlamaConfig.tiny(dtype=torch.bfloat16, qkv_bias=True, qk_norm=True,
                             post_norms=True)


def _params(seed):
    p = llama.init_params(CFG, seed=seed, device="cpu")
    for lp in p["layers"]:  # nonzero biases and norms, so every leaf is seen
        for k in ("bq", "bk", "bv", "attn_norm", "q_norm"):
            lp[k] = lp[k] + torch.randn(lp[k].shape, generator=torch.Generator().manual_seed(seed)
                                        ).to(lp[k].dtype)
    return p


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


@pytest.mark.parametrize("quantized", [False, True])
def test_round_trip_is_bit_exact(tmp_path, quantized):
    params = _params(1)
    if quantized:
        params = quantize_params(params)
        assert isinstance(params["layers"][0]["wq"], QWeight)
        assert isinstance(params["embed"], QWeight)
        # biases and norms stay in full precision, as mfa_tpu leaves them
        assert params["layers"][0]["bq"].dtype == torch.bfloat16
        assert params["layers"][0]["attn_norm"].dtype == torch.float32
    like = _params(2)  # the structure and dtypes only
    if quantized:
        like = quantize_params(like)
    save_params(str(tmp_path / "ckpt"), params)  # ".npz" appended, as np.savez does
    back = load_params(str(tmp_path / "ckpt"), like)
    got, want = _flatten(back), _flatten(params)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert any(t.dtype == torch.bfloat16 for _, t in want)
    for (path, a), (_, b) in zip(got, want):
        assert _same_bits(a, b), path
    if quantized:
        assert back["layers"][1]["w_down"].axis == -2 and back["embed"].axis == -1
    # the loaded model computes what the saved one did
    toks = torch.tensor([[3, 1, 4, 1, 5]])
    assert torch.equal(llama.forward(back, toks, CFG), llama.forward(params, toks, CFG))


def test_mismatch_raises(tmp_path):
    path = str(tmp_path / "p.npz")
    save_params(path, _params(1))
    other = llama.init_params(dataclasses.replace(CFG, qkv_bias=False), device="cpu")
    with pytest.raises(ValueError, match="structure mismatch"):
        load_params(path, other)
    deeper = llama.init_params(dataclasses.replace(CFG, n_layers=3), device="cpu")
    with pytest.raises(ValueError, match="structure mismatch"):
        load_params(path, deeper)
    with pytest.raises(ValueError, match="structure mismatch"):
        load_params(path, quantize_params(_params(1)))


def test_paths_are_stored_beside_the_leaves(tmp_path):
    params = _params(3)
    path = str(tmp_path / "p.npz")
    save_params(path, params)
    with np.load(path) as data:
        paths = json.loads(str(data["__paths__"]))
        assert paths == [p for p, _ in _flatten(params)]
        assert "['layers'][0]['bq']" in paths
        assert data["leaf_0"].dtype in (np.int16, np.float32)
