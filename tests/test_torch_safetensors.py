"""The port's safetensors reader/writer (models/safetensors_io.py) against
mfa_tpu's: a single-file round trip in every dtype of the format, a
sharded HF-layout checkpoint (two bf16 shards + index + config.json) that
from_safetensors loads equal to from_hf of the same bf16-rounded tensors
(and, converted, equal to mfa_tpu's load), the lazy reader reads nothing
until asked, and files written by either package read byte-equal in the
other. No safetensors package is used, and the port's module imports no
ml_dtypes (the JAX side of these tests does)."""

import json
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mfa_tpu.models import convert as jconvert
from mfa_tpu.models import safetensors_io as jst
from mfa_tpu_torch.models import convert, llama
from mfa_tpu_torch.models import safetensors_io as st
from tests.jax_maps import release_jax_code  # noqa: F401

HF_CFG = dict(
    model_type="llama", vocab_size=96, hidden_size=64,
    intermediate_size=112, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, rms_norm_eps=1e-5, rope_theta=10000.0,
    max_position_embeddings=256, tie_word_embeddings=False,
)

# every dtype of the format: torch dtype, the numpy dtype JAX's module maps it to
DTYPES = {
    "F64": (torch.float64, np.float64), "F32": (torch.float32, np.float32),
    "F16": (torch.float16, np.float16), "BF16": (torch.bfloat16, ml_dtypes.bfloat16),
    "F8_E4M3": (torch.float8_e4m3fn, ml_dtypes.float8_e4m3fn),
    "F8_E5M2": (torch.float8_e5m2, ml_dtypes.float8_e5m2),
    "I64": (torch.int64, np.int64), "I32": (torch.int32, np.int32),
    "I16": (torch.int16, np.int16), "I8": (torch.int8, np.int8),
    "U8": (torch.uint8, np.uint8), "BOOL": (torch.bool, np.bool_),
}


def _tensors(seed=0):
    """One tensor of each dtype, from numpy with a seed (floats rounded
    to their dtype by the numpy side, so both packages hold the same bits)."""
    rng = np.random.RandomState(seed)
    out = {}
    for i, (st_name, (tdt, ndt)) in enumerate(DTYPES.items()):
        shape = (3, 5) if i % 2 else (7,)
        if tdt.is_floating_point:
            a = (rng.standard_normal(shape) * 4).astype(np.float32).astype(ndt)
        elif tdt == torch.bool:
            a = rng.randint(0, 2, shape).astype(np.bool_)
        else:
            a = rng.randint(-100 if tdt != torch.uint8 else 0, 100, shape).astype(ndt)
        out[st_name] = a
    return out


def _as_torch(a: np.ndarray, tdt) -> torch.Tensor:
    """A numpy array (ml_dtypes included) as a torch tensor of the same bits."""
    raw = torch.from_numpy(np.ascontiguousarray(a).view(np.uint8).reshape(-1).copy())
    return raw.view(tdt).reshape(a.shape)


def _bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _tiny_state_dict(seed=0):
    rng = np.random.default_rng(seed)
    d, ffn, kv_d = 64, 112, 32
    sd = {
        "model.embed_tokens.weight": rng.standard_normal((96, d)),
        "model.norm.weight": rng.standard_normal((d,)),
        "lm_head.weight": rng.standard_normal((96, d)),
    }
    for i in range(2):
        p = f"model.layers.{i}."
        sd.update({
            p + "self_attn.q_proj.weight": rng.standard_normal((d, d)),
            p + "self_attn.k_proj.weight": rng.standard_normal((kv_d, d)),
            p + "self_attn.v_proj.weight": rng.standard_normal((kv_d, d)),
            p + "self_attn.o_proj.weight": rng.standard_normal((d, d)),
            p + "mlp.gate_proj.weight": rng.standard_normal((ffn, d)),
            p + "mlp.up_proj.weight": rng.standard_normal((ffn, d)),
            p + "mlp.down_proj.weight": rng.standard_normal((d, ffn)),
            p + "input_layernorm.weight": rng.standard_normal((d,)),
            p + "post_attention_layernorm.weight": rng.standard_normal((d,)),
        })
    return {k: torch.from_numpy((v * 0.05).astype(np.float32)) for k, v in sd.items()}


@pytest.fixture()
def checkpoint_dir(tmp_path):
    sd = _tiny_state_dict()
    names = sorted(sd)
    half = len(names) // 2
    shards = {"model-00001-of-00002.safetensors": names[:half],
              "model-00002-of-00002.safetensors": names[half:]}
    weight_map = {}
    for fname, keys in shards.items():
        st.write_safetensors(str(tmp_path / fname),
                             {k: sd[k].to(torch.bfloat16) for k in keys})
        weight_map.update({k: fname for k in keys})
    with open(tmp_path / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": weight_map}, f)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(HF_CFG, f)
    return tmp_path, sd


def test_roundtrip_single_file(tmp_path):
    arrs = {k: _as_torch(a, DTYPES[k][0]) for k, a in _tensors().items()}
    path = str(tmp_path / "one.safetensors")
    st.write_safetensors(path, arrs)
    back = st.read_safetensors(path)
    assert set(back) == set(arrs)
    for k, t in arrs.items():
        got = back[k]
        assert got.dtype == t.dtype and got.shape == t.shape, k
        assert _bytes(got) == _bytes(t), k


def test_sharded_checkpoint_matches_from_hf(checkpoint_dir):
    path, sd = checkpoint_dir
    hf_config = types.SimpleNamespace(**HF_CFG)
    sd_bf16 = {k: v.to(torch.bfloat16).float() for k, v in sd.items()}
    ref, ref_cfg = convert.from_hf(sd_bf16, hf_config, dtype=torch.float32,
                                   device="cpu")
    params, cfg = convert.from_safetensors(str(path), dtype=torch.float32,
                                           device="cpu")
    assert cfg == ref_cfg
    from mfa_tpu_torch.utils.checkpoint import _flatten

    got = dict(_flatten(params))
    want = _flatten(ref)
    assert len(got) == len(want)
    for key, leaf in want:
        assert torch.equal(got[key], leaf), key
    # mfa_tpu's loader on the same directory gives the same weights
    jparams, _ = jconvert.from_safetensors(str(path), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jparams)
    conv = llama.params_from_numpy(tree, cfg, "cpu")
    for key, leaf in _flatten(conv):
        assert torch.equal(got[key], leaf), key
    logits = llama.forward(params, torch.tensor([[1, 5, 9, 2]]), cfg)
    assert logits.shape == (1, 4, 96) and torch.isfinite(logits).all()


def test_lazy_reader_is_lazy(checkpoint_dir, monkeypatch):
    path, sd = checkpoint_dir
    lazy = st.read_safetensors(str(path))
    reads = []
    real_open = open

    def counting_open(file, mode="r", *a, **kw):
        reads.append((str(file), mode))
        return real_open(file, mode, *a, **kw)

    monkeypatch.setattr("builtins.open", counting_open)
    assert set(lazy) == set(sd)  # the key inventory reads no payload
    assert not reads
    one = "model.layers.0.self_attn.q_proj.weight"
    got = lazy[one]
    assert len(reads) == 1  # one tensor, one read
    assert torch.equal(got, sd[one].to(torch.bfloat16))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_files_cross_read_byte_equal(tmp_path, writer):
    """A file written by one package reads in the other with the same
    names, shapes, dtypes and bytes, and the two writers give the same
    file."""
    arrs = _tensors(1)
    path = str(tmp_path / f"{writer}.safetensors")
    if writer == "jax":
        jst.write_safetensors(path, arrs)
        back = st.read_safetensors(path)
        for k, a in arrs.items():
            assert back[k].dtype == DTYPES[k][0] and tuple(back[k].shape) == a.shape
            assert _bytes(back[k]) == np.ascontiguousarray(a).tobytes(), k
    else:
        st.write_safetensors(path, {k: _as_torch(a, DTYPES[k][0])
                                    for k, a in arrs.items()})
        back = jst.read_safetensors(path)
        for k, a in arrs.items():
            assert back[k].dtype == np.dtype(DTYPES[k][1]) and back[k].shape == a.shape
            assert np.asarray(back[k]).tobytes() == np.ascontiguousarray(a).tobytes(), k
        other = str(tmp_path / "jax.safetensors")
        jst.write_safetensors(other, arrs)
        with open(path, "rb") as f, open(other, "rb") as g:
            assert f.read() == g.read()
