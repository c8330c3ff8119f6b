"""``tgq_torch.models.hf_import`` against ``tgq.models.hf_import``:
``config_from_hf`` field for field, the opt-350m refusal, the tensors of
the same HF checkpoint files loaded bit for bit alike, and
``resolve_model`` for a local directory and a hub id in a local HF cache.

One difference is the JAX package's fault, not the port's: its GPT-2
mapping drops every tensor whose name ends with ``attn.bias`` to skip the
causal-mask buffers, and ``attn.c_attn.bias`` ends with it too.  The port
keeps c_attn's bias; the test checks that this is the only difference."""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from tgq.models import PRESETS as J_PRESETS
from tgq.models import init_params as j_init
from tgq.models.hf_export import export_hf as j_export
from tgq.models.hf_import import config_from_hf as j_config_from_hf
from tgq.models.hf_import import load_hf_checkpoint as j_load
from tgq_torch.models.causal_lm import forward, get_nested
from tgq_torch.models.convert import params_from_numpy
from tgq_torch.models.hf_import import config_from_hf, load_hf_checkpoint, resolve_model

HF_CONFIGS = {
    "qwen3": {"model_type": "qwen3", "vocab_size": 100, "hidden_size": 64,
              "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
              "num_key_value_heads": 2, "head_dim": 16, "rope_theta": 1e4,
              "tie_word_embeddings": True, "_name_or_path": "Qwen/Qwen3-tiny"},
    "llama": {"model_type": "llama", "vocab_size": 128256, "hidden_size": 4096,
              "intermediate_size": 14336, "num_hidden_layers": 32, "num_attention_heads": 32,
              "num_key_value_heads": 8, "rope_theta": 5e5, "rms_norm_eps": 1e-5,
              "max_position_embeddings": 8192},
    "qwen2": {"model_type": "qwen2", "vocab_size": 152064, "hidden_size": 3584,
              "intermediate_size": 18944, "num_hidden_layers": 28, "num_attention_heads": 28,
              "num_key_value_heads": 4, "rope_theta": 1e6},
    "gpt2": {"model_type": "gpt2", "vocab_size": 50257, "n_embd": 768, "n_layer": 12,
             "n_head": 12, "n_positions": 1024, "layer_norm_epsilon": 1e-5},
    "gpt2-xl": {"model_type": "gpt2", "vocab_size": 50257, "n_embd": 1600, "n_layer": 48,
                "n_head": 25, "n_inner": None, "n_positions": 1024,
                "_name_or_path": "gpt2-xl"},
    "opt": {"model_type": "opt", "vocab_size": 50272, "hidden_size": 2048, "ffn_dim": 8192,
            "num_hidden_layers": 24, "num_attention_heads": 32,
            "max_position_embeddings": 2048, "word_embed_proj_dim": 2048,
            "do_layer_norm_before": True, "_name_or_path": "facebook/opt-1.3b"},
}


@pytest.mark.parametrize("name", sorted(HF_CONFIGS))
def test_config_from_hf_matches_jax(name):
    got = dataclasses.asdict(config_from_hf(dict(HF_CONFIGS[name])))
    want = dataclasses.asdict(j_config_from_hf(dict(HF_CONFIGS[name])))
    assert got == want


@pytest.mark.parametrize("bad,match", [({"word_embed_proj_dim": 512}, "word_embed_proj_dim"),
                                       ({"do_layer_norm_before": False}, "post-norm")])
def test_opt_350m_rejected(bad, match):
    base = {"model_type": "opt", "vocab_size": 50272, "hidden_size": 1024, "ffn_dim": 4096,
            "num_hidden_layers": 24, "num_attention_heads": 16,
            "max_position_embeddings": 2048}
    with pytest.raises(ValueError, match=match):
        config_from_hf({**base, **bad})
    with pytest.raises(ValueError, match=match):
        j_config_from_hf({**base, **bad})


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


def _write_gpt2_hf(params, cfg, path):
    """A GPT-2 checkpoint as HF writes it: transformer.* names, Conv1D
    (in, out) weights, f32 causal-mask buffers, an f32 tied lm_head."""
    from safetensors.numpy import save_file

    m = params["model"]
    t = {"transformer.wte.weight": m["embed_tokens"]["weight"],
         "transformer.wpe.weight": m["wpe"]["weight"],
         "transformer.ln_f.weight": m["norm"]["weight"],
         "transformer.ln_f.bias": m["norm"]["bias"],
         "lm_head.weight": np.asarray(m["embed_tokens"]["weight"], np.float32)}
    for i, lp in enumerate(m["layers"]):
        p = f"transformer.h.{i}."
        for ln in ("ln_1", "ln_2"):
            t[p + ln + ".weight"], t[p + ln + ".bias"] = lp[ln]["weight"], lp[ln]["bias"]
        for mod, sub in (("attn", "c_attn"), ("attn", "c_proj"), ("mlp", "c_fc"),
                         ("mlp", "c_proj")):
            t[f"{p}{mod}.{sub}.weight"] = np.asarray(lp[mod][sub]["w"]).T
            t[f"{p}{mod}.{sub}.bias"] = lp[mod][sub]["b"]
        t[p + "attn.bias"] = np.tril(np.ones((1, 1, 8, 8), np.float32))
        t[p + "attn.masked_bias"] = np.asarray(-1e4, np.float32)
    os.makedirs(path)
    save_file({k: np.ascontiguousarray(v) for k, v in t.items()},
              os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "gpt2", "vocab_size": cfg.vocab_size,
                   "n_embd": cfg.hidden_size, "n_layer": cfg.num_layers,
                   "n_head": cfg.num_heads, "n_inner": cfg.intermediate_size,
                   "n_positions": cfg.max_position_embeddings,
                   "layer_norm_epsilon": cfg.rms_norm_eps}, f)


@pytest.mark.parametrize("preset", ["tiny-qwen3", "tiny-qwen2", "tiny-llama", "tiny-opt",
                                    "tiny-gpt2", "tiny-gpt2-hf"])
def test_loaded_tensors_equal_jax(tmp_path, preset):
    """The same files (written by the JAX package's exporter, or for
    tiny-gpt2-hf in HF's own GPT-2 layout) load into the same tree with the
    same bits in both packages, biases given nonzero values first."""
    name = preset.replace("-hf", "")
    cfg = J_PRESETS[name]
    params = j_init(cfg, jax.random.key(3))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + rng.standard_normal(x.shape).astype(np.float32) * 0.1
                      ).astype(x.dtype) if jax.tree_util.keystr(p).endswith(("'b']",
                                                                            "'bias']")) else x,
        params)
    path = str(tmp_path / "ckpt")
    if preset == "tiny-gpt2-hf":
        _write_gpt2_hf(jax.tree.map(np.asarray, params), cfg, path)
    else:
        j_export(path, params, cfg)
    jp, jcfg = j_load(path)
    tp, tcfg = load_hf_checkpoint(path, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    want = dict(_leaves(params_from_numpy(jp)))
    got = dict(_leaves(tp))
    if cfg.family == "gpt2":
        extra = {k for k in got if k.endswith("attn.c_attn.b")}
        assert len(extra) == cfg.num_layers and not extra & set(want)
        src = params_from_numpy(jax.tree.map(np.asarray, params))
        for k in extra:
            li = int(k.split(".")[2])
            assert torch.equal(_bits(got.pop(k)),
                               _bits(src["model"]["layers"][li]["attn"]["c_attn"]["b"]))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(_bits(got[k]), _bits(want[k])), k


def test_roundtrip_forward(tmp_path):
    """Mirror of tests/test_hf_import.py::test_roundtrip_forward: the
    loaded model's logits equal the source weights' bit for bit."""
    cfg = J_PRESETS["tiny-qwen3"]
    params = j_init(cfg, jax.random.key(0))
    j_export(str(tmp_path / "m"), params, cfg)
    tp, tcfg = load_hf_checkpoint(str(tmp_path / "m"), device="cpu")
    src = params_from_numpy(jax.tree.map(np.asarray, params))
    ids = torch.tensor([[1, 5, 9, 200, 3]])
    assert torch.equal(forward(tp, tcfg, ids), forward(src, cfg, ids))


def _export_port(path, preset):
    from tgq_torch.models import PRESETS
    from tgq_torch.models.causal_lm import init_params
    from tgq_torch.models.hf_export import export_hf

    cfg = PRESETS[preset]
    params = init_params(cfg, seed=1, device="cpu")
    export_hf(path, params, cfg)
    return params, cfg


def test_resolve_model_local_dir(tmp_path):
    params, cfg = _export_port(str(tmp_path / "m"), "tiny-opt")
    got, got_cfg, tok = resolve_model(str(tmp_path / "m"), device="cpu")
    assert tok is None and got_cfg.family == "opt"
    w = get_nested(got["model"]["layers"][1], "fc2")["w"]
    assert torch.equal(_bits(w), _bits(params["model"]["layers"][1]["fc2"]["w"]))


@pytest.mark.parametrize("env", ["HF_HUB_CACHE", "HF_HOME"])
def test_resolve_model_hub_cache(tmp_path, monkeypatch, env):
    """A hub id resolves from the HF cache layout: models--org--name,
    refs/main naming the snapshot."""
    root = tmp_path / "cache"
    hub = root / "hub" if env == "HF_HOME" else root
    repo = hub / "models--facebook--opt-tiny"
    _export_port(str(repo / "snapshots" / "abc123"), "tiny-opt")
    os.makedirs(repo / "refs")
    (repo / "refs" / "main").write_text("abc123\n")
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.setenv(env, str(root))
    params, cfg, tok = resolve_model("facebook/opt-tiny", device="cpu")
    assert cfg.family == "opt" and tok is None and len(params["model"]["layers"]) == 2
    with pytest.raises(ValueError, match="not in the local HF cache"):
        resolve_model("facebook/opt-absent", device="cpu")


def test_resolve_model_preset():
    params, cfg, tok = resolve_model("tiny-gpt2", seed=0, device="cpu")
    assert cfg.family == "gpt2" and tok is None and "wpe" in params["model"]
