"""``tgq_torch.models.hf_export`` against ``tgq.models.hf_export``: the two
exporters write the same tensors (names, dtypes, bits) and the same
config.json, the port's export loads in the JAX package's
``load_hf_checkpoint`` and the JAX package's in the port's, packed linears
export dequantized with their bias, and big exports shard with an index.

The JAX package's GPT-2 import drops ``attn.c_attn.bias`` (its mask-buffer
filter matches that suffix; see ``tests/test_torch_hf_import.py``), so a
GPT-2 tree it loads lacks those tensors and nothing else."""
import json
import os

import jax
import numpy as np
import pytest
import torch
from safetensors import safe_open

from tgq.models import PRESETS as J_PRESETS
from tgq.models import init_params as j_init
from tgq.models.hf_export import export_hf as j_export
from tgq.models.hf_export import hf_config_dict as j_hf_config_dict
from tgq.models.hf_import import load_hf_checkpoint as j_load
from tgq_torch.models import PRESETS
from tgq_torch.models.causal_lm import forward, get_nested, set_nested
from tgq_torch.models.convert import params_from_numpy
from tgq_torch.models.hf_export import export_hf, hf_config_dict
from tgq_torch.models.hf_import import load_hf_checkpoint, rtn_pack
from tgq_torch.models.safetensors_io import INDEX_NAME, iter_checkpoint

PRESET_NAMES = ["tiny-qwen3", "tiny-qwen2", "tiny-llama", "tiny-gpt2", "tiny-opt"]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _both(preset):
    jp = j_init(J_PRESETS[preset], jax.random.key(2))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _files(path):
    out = {}
    for name in sorted(os.listdir(path)):
        if name.endswith(".safetensors"):
            with safe_open(os.path.join(path, name), framework="pt") as f:
                out.update({k: f.get_tensor(k) for k in f.keys()})
    return out


@pytest.mark.parametrize("preset", sorted(J_PRESETS))
def test_hf_config_dict_matches_jax(preset):
    assert hf_config_dict(PRESETS[preset]) == j_hf_config_dict(J_PRESETS[preset])


@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_same_files_as_jax_export(tmp_path, preset):
    jp, tp = _both(preset)
    cfg = PRESETS[preset]
    j_export(str(tmp_path / "j"), jp, J_PRESETS[preset])
    export_hf(str(tmp_path / "t"), tp, cfg)
    jt, tt = _files(tmp_path / "j"), _files(tmp_path / "t")
    assert set(tt) == set(jt)
    for k in jt:
        assert tt[k].dtype == jt[k].dtype and torch.equal(_bits(tt[k]), _bits(jt[k])), k
    assert json.load(open(tmp_path / "t" / "config.json")) == \
        json.load(open(tmp_path / "j" / "config.json"))


@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_port_export_loads_in_jax(tmp_path, preset):
    _, tp = _both(preset)
    cfg = PRESETS[preset]
    export_hf(str(tmp_path / "t"), tp, cfg)
    jp, jcfg = j_load(str(tmp_path / "t"))
    assert jcfg.family == cfg.family and jcfg.num_layers == cfg.num_layers
    got = dict(_leaves(params_from_numpy(jp)))
    want = dict(_leaves(tp))
    dropped = set(want) - set(got)
    assert dropped == ({k for k in want if k.endswith("attn.c_attn.b")}
                       if cfg.family == "gpt2" else set())
    assert set(got) <= set(want)
    for k in got:
        assert torch.equal(_bits(got[k]), _bits(want[k])), k


@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_jax_export_loads_in_port(tmp_path, preset):
    jp, tp = _both(preset)
    j_export(str(tmp_path / "j"), jp, J_PRESETS[preset])
    got, cfg = load_hf_checkpoint(str(tmp_path / "j"), device="cpu")
    assert cfg.family == PRESETS[preset].family
    got, want = dict(_leaves(got)), dict(_leaves(tp))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(_bits(got[k]), _bits(want[k])), k
    ids = torch.tensor([[1, 5, 9, 200, 3, 44]])
    got_tree, _ = load_hf_checkpoint(str(tmp_path / "j"), device="cpu")
    assert torch.equal(forward(got_tree, cfg, ids), forward(tp, cfg, ids))


def test_packed_dequant_export(tmp_path):
    """A packed linear (tiny-qwen2's biased q_proj) exports as its
    dequantized bf16 weight with its bias, the same bits as the JAX
    package's export of the same packed linear."""
    from tgq.core.packing import PackedLinear as JPacked
    from tgq.models.causal_lm import set_nested as j_set_nested
    from tgq_torch.core.quant import QuantSpec

    jp, tp = _both("tiny-qwen2")
    cfg = PRESETS["tiny-qwen2"]
    lp = tp["model"]["layers"][0]
    entry = get_nested(lp, "self_attn.q_proj")
    pl = rtn_pack(entry["w"], QuantSpec(bits=4, group_size=-1, sym=False),
                  bias=entry["b"].float())
    set_nested(lp, "self_attn.q_proj", pl)
    j_set_nested(jp["model"]["layers"][0], "self_attn.q_proj", JPacked(
        codes=pl.codes.numpy(), scale=pl.scale.numpy(), zero=pl.zero.numpy(), bits=4,
        group_size=pl.group_size, in_features=pl.in_features, out_features=pl.out_features,
        bias=pl.bias.numpy()))
    export_hf(str(tmp_path / "t"), tp, cfg)
    j_export(str(tmp_path / "j"), jp, J_PRESETS["tiny-qwen2"])
    jt, tt = _files(tmp_path / "j"), _files(tmp_path / "t")
    name = "model.layers.0.self_attn.q_proj"
    for k in (f"{name}.weight", f"{name}.bias"):
        assert torch.equal(_bits(tt[k]), _bits(jt[k])), k
    assert torch.equal(tt[f"{name}.weight"], pl.dequantize().to(torch.bfloat16))
    got, _ = load_hf_checkpoint(str(tmp_path / "t"), device="cpu")
    assert "b" in get_nested(got["model"]["layers"][0], "self_attn.q_proj")


def test_export_shards_with_index(tmp_path):
    _, tp = _both("tiny-opt")
    cfg = PRESETS["tiny-opt"]
    export_hf(str(tmp_path / "t"), tp, cfg, max_shard_bytes=64 * 1024)
    index = json.load(open(tmp_path / "t" / INDEX_NAME))
    assert len(set(index["weight_map"].values())) > 1
    assert set(index["weight_map"]) == {k for k, _ in iter_checkpoint(str(tmp_path / "t"))}
    jp, _ = j_load(str(tmp_path / "t"))  # the JAX package reads the shards too
    got, _ = load_hf_checkpoint(str(tmp_path / "t"), device="cpu")
    want = dict(_leaves(tp))
    assert all(torch.equal(_bits(v), _bits(want[k])) for k, v in _leaves(got))
    assert len(dict(_leaves(jp))) == len(want)
