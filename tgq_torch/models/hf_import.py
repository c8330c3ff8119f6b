"""HF checkpoints in, and random presets (mirrors
``tgq/models/hf_import.py``).

- :func:`config_from_hf` maps an HF ``config.json`` (qwen3, qwen2, llama,
  gpt2, opt) to a ``ModelConfig``.
- :func:`load_hf_checkpoint` reads a local safetensors checkpoint
  (``tgq_torch.models.safetensors_io``, one tensor at a time) into the
  port's parameter tree on the target device.  The tree mirrors the HF
  names, so import is a rename: ``*.weight`` → ``w`` on linears, GPT-2's
  Conv1D weights transposed to (out, in).
- :func:`resolve_model`: a preset (random weights), a local directory, or
  a hub id found in the local HF cache.  There is no tokenizer
  (``transformers`` is not a dependency): callers get ``None``.
- :func:`init_packed_params` makes a preset's weights directly as
  RTN-packed linears, one linear at a time on the device, so a dense copy
  of the whole model never exists.  Content-equivalent to ``init_params``
  followed by an RTN pack of the same spec, not bit-identical to the JAX
  package's (``torch.Generator`` is not ``jax.random``).
"""
from __future__ import annotations

import json
import logging
import os

import torch

from tgq_torch.core.packing import PackedLinear, pad_out
from tgq_torch.core.quant import QuantSpec, expand_params, find_params, quantize
from tgq_torch.models.causal_lm import set_nested
from tgq_torch.models.config import PRESETS, ModelConfig
from tgq_torch.models.safetensors_io import iter_checkpoint
from tgq_torch.utils.precision import resolve_device

logger = logging.getLogger(__name__)


def config_from_hf(hf_cfg: dict) -> ModelConfig:
    model_type = hf_cfg.get("model_type", "")
    if model_type == "gpt2":
        # transformer.h layout: n_* config names, Conv1D weights
        h = hf_cfg["n_embd"]
        return ModelConfig(
            name=hf_cfg.get("_name_or_path") or "gpt2",
            vocab_size=hf_cfg["vocab_size"], hidden_size=h,
            intermediate_size=hf_cfg.get("n_inner") or 4 * h,
            num_layers=hf_cfg["n_layer"], num_heads=hf_cfg["n_head"],
            num_kv_heads=hf_cfg["n_head"], head_dim=h // hf_cfg["n_head"],
            rms_norm_eps=hf_cfg.get("layer_norm_epsilon", 1e-5),
            qk_norm=False, tie_word_embeddings=True,
            max_position_embeddings=hf_cfg.get("n_positions", 1024),
            seqlen=min(2048, hf_cfg.get("n_positions", 1024)),
            family="gpt2",
        )
    if model_type == "opt":
        h = hf_cfg["hidden_size"]
        if hf_cfg.get("word_embed_proj_dim", h) != h:
            raise ValueError(
                "OPT variants with word_embed_proj_dim != hidden_size "
                "(project_in/out, e.g. opt-350m) are not supported")
        if not hf_cfg.get("do_layer_norm_before", True):
            raise ValueError(
                "post-norm OPT variants (do_layer_norm_before=False, "
                "e.g. opt-350m) are not supported")
        heads = hf_cfg["num_attention_heads"]
        return ModelConfig(
            name=hf_cfg.get("_name_or_path") or "opt",
            vocab_size=hf_cfg["vocab_size"], hidden_size=h,
            intermediate_size=hf_cfg.get("ffn_dim") or 4 * h,
            num_layers=hf_cfg["num_hidden_layers"], num_heads=heads,
            num_kv_heads=heads, head_dim=h // heads,
            rms_norm_eps=1e-5, qk_norm=False,
            tie_word_embeddings=hf_cfg.get("tie_word_embeddings", True),
            max_position_embeddings=hf_cfg.get("max_position_embeddings", 2048),
            seqlen=min(2048, hf_cfg.get("max_position_embeddings", 2048)),
            family="opt",
        )
    head_dim = hf_cfg.get("head_dim") or (
        hf_cfg["hidden_size"] // hf_cfg["num_attention_heads"])
    return ModelConfig(
        name=hf_cfg.get("_name_or_path", model_type) or model_type,
        vocab_size=hf_cfg["vocab_size"],
        hidden_size=hf_cfg["hidden_size"],
        intermediate_size=hf_cfg["intermediate_size"],
        num_layers=hf_cfg["num_hidden_layers"],
        num_heads=hf_cfg["num_attention_heads"],
        num_kv_heads=hf_cfg.get("num_key_value_heads", hf_cfg["num_attention_heads"]),
        head_dim=head_dim,
        rope_theta=hf_cfg.get("rope_theta", 1e4),
        rms_norm_eps=hf_cfg.get("rms_norm_eps", 1e-6),
        qk_norm=model_type == "qwen3",
        attention_bias=hf_cfg.get("attention_bias", model_type == "qwen2"),
        tie_word_embeddings=hf_cfg.get("tie_word_embeddings", False),
        max_position_embeddings=hf_cfg.get("max_position_embeddings", 40960),
    )


def _linear_leaf(name: str, t: torch.Tensor, modules: tuple[str, ...] | None,
                 transpose: bool = False):
    """``<module>.weight``/``.bias`` of a quantizable linear → ``.w``/``.b``
    (``modules`` None: any ``*_proj`` or the head); else the name kept."""
    parts = name.split(".")
    if len(parts) >= 2 and parts[-1] in ("weight", "bias"):
        mod = parts[-2]
        is_linear = (mod in modules if modules is not None
                     else mod.endswith("_proj") or name == "lm_head.weight")
        if is_linear:
            leaf = "w" if parts[-1] == "weight" else "b"
            if leaf == "w" and transpose:
                t = t.T.contiguous()
            return name.rsplit(".", 1)[0] + "." + leaf, t
    return name, t


def _map_gpt2_tensor(key: str, t: torch.Tensor):
    """HF GPT-2 name → the port's tree (``tgq_torch.models.gpt2``), or None
    to skip.  transformer.wte → model.embed_tokens, wpe → model.wpe,
    h.N → model.layers.N, ln_f → model.norm; Conv1D weights are stored
    (in, out) and transpose to (out, in); the causal-mask buffers
    (``h.N.attn.bias``, ``h.N.attn.masked_bias``) and a tied lm_head are
    dropped.  The JAX package tests the suffix ``attn.bias``, which
    ``attn.c_attn.bias`` also ends with, and so drops c_attn's bias; here
    only the buffers go."""
    parts = key.split(".")
    if key.startswith("lm_head.") or (
            len(parts) >= 2 and parts[-2] == "attn" and parts[-1] in ("bias", "masked_bias")):
        return None
    name = key[len("transformer."):] if key.startswith("transformer.") else key
    for hf, ours in (("wte.", "model.embed_tokens."), ("wpe.", "model.wpe."),
                     ("ln_f.", "model.norm."), ("h.", "model.layers.")):
        if name.startswith(hf):
            name = ours + name[len(hf):]
            break
    return _linear_leaf(name, t, ("c_attn", "c_proj", "c_fc"), transpose=True)


def _map_opt_tensor(key: str, t: torch.Tensor):
    """HF OPT name → the port's tree (``tgq_torch.models.opt``), or None to
    skip.  model.decoder.embed_tokens → model.embed_tokens,
    embed_positions → model.wpe (offset rows kept), final_layer_norm →
    model.norm, layers.N → model.layers.N; nn.Linear weights need no
    transpose; a tied lm_head is dropped."""
    if key.startswith("lm_head."):
        return None
    name = key
    for hf in ("model.decoder.", "decoder."):
        if name.startswith(hf):
            name = "model." + name[len(hf):]
            break
    for hf, ours in (("model.embed_positions.", "model.wpe."),
                     ("model.final_layer_norm.", "model.norm.")):
        if name.startswith(hf):
            name = ours + name[len(hf):]
    return _linear_leaf(name, t, ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2"))


def load_hf_checkpoint(path: str, dtype=torch.bfloat16, device: str = "cuda"):
    """(params, ModelConfig) from a local HF checkpoint directory, each
    tensor read from its shard and moved to ``device`` in turn; floating
    tensors become ``dtype``."""
    dev = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    mapper = {"gpt2": _map_gpt2_tensor, "opt": _map_opt_tensor}.get(
        cfg.family, lambda key, t: _linear_leaf(key, t, None))
    params: dict = {"model": {"layers": [{} for _ in range(cfg.num_layers)]}}

    def put(dotted: str, t: torch.Tensor) -> None:
        parts = dotted.split(".")
        cur = params
        for part in parts[:-1]:
            cur = cur[int(part)] if part.isdigit() else cur.setdefault(part, {})
        cur[parts[-1]] = t

    n = 0
    for key, t in iter_checkpoint(path):
        mapped = mapper(key, t)
        if mapped is None:
            continue
        name, t = mapped
        if t.is_floating_point():
            t = t.to(dtype)
        put(name, t.to(dev))
        n += 1
    logger.info("[hf] imported %d tensors from %s", n, path)
    if cfg.tie_word_embeddings:
        params.pop("lm_head", None)
    return params, cfg


def _hub_snapshot(model_id: str) -> str | None:
    """The local snapshot directory of a hub id in the HF cache layout
    (``$HF_HUB_CACHE``, else ``$HF_HOME/hub``, else
    ``~/.cache/huggingface/hub``): ``models--<org>--<name>/snapshots/<rev>``
    with ``<rev>`` from ``refs/main``.  None when absent."""
    cache = os.environ.get("HF_HUB_CACHE") or os.path.join(
        os.environ.get("HF_HOME") or os.path.join(os.path.expanduser("~"), ".cache",
                                                  "huggingface"), "hub")
    repo = os.path.join(cache, "models--" + model_id.replace("/", "--"))
    ref = os.path.join(repo, "refs", "main")
    if not os.path.isfile(ref):
        return None
    with open(ref) as f:
        snap = os.path.join(repo, "snapshots", f.read().strip())
    return snap if os.path.isfile(os.path.join(snap, "config.json")) else None


def resolve_model(model_id: str, seed: int = 0, device: str = "cuda"):
    """(params, cfg, tokenizer) for a preset (random weights from
    ``seed``), a local HF directory, or a hub id in the local HF cache.
    The tokenizer is always None."""
    from tgq_torch.models.causal_lm import init_params

    if model_id in PRESETS:
        logger.info("[model] preset %s (random init)", model_id)
        cfg = PRESETS[model_id]
        return init_params(cfg, seed=seed, device=device), cfg, None
    path = model_id if os.path.isdir(model_id) else _hub_snapshot(model_id)
    if path is None:
        raise ValueError(
            f"model_id {model_id!r} is not a tgq_torch preset "
            f"({', '.join(sorted(PRESETS))}), not a local directory, and not in "
            "the local HF cache (models--<org>--<name>/refs/main)")
    params, cfg = load_hf_checkpoint(path, device=device)
    return params, cfg, None


def rtn_pack(w: torch.Tensor, spec: QuantSpec, bias=None) -> PackedLinear:
    """Round-to-nearest pack of an (out, in) weight."""
    w = w.float()
    p = find_params(w, spec)
    s, z = expand_params(p, w.shape[1])
    q = quantize(w, s, z, spec).to(torch.int32)
    return PackedLinear.from_codes(q, p.scale, p.zero, spec, bias=bias)


def init_packed_params(cfg: ModelConfig, spec: QuantSpec, seed: int = 0,
                       lm_head_bits: int = 16, device: str = "cuda"):
    """Random-init a llama-family preset as RTN-packed weights: every
    decoder linear is N(0, 1/in) drawn in f32 and packed with ``spec``;
    embeddings and a dense head are N(0, 0.02²) bf16; norms are ones.
    ``lm_head_bits < 16`` packs the head too (same group size, asymmetric)
    and pads its rows to a multiple of 512 (``pad_out``)."""
    if cfg.family != "llama":
        raise NotImplementedError(
            f"packed random init of the {cfg.family!r} family: the serving engine "
            "is llama-family")
    if cfg.attention_bias:
        raise NotImplementedError(
            "packed random init with attention bias: use init_params + an RTN pack")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def packed(out_f, in_f, scale, pspec):
        w = torch.randn((out_f, in_f), generator=gen, device=dev, dtype=torch.float32)
        return rtn_pack(w * scale, pspec)

    def dense(out_f, in_f):
        w = torch.randn((out_f, in_f), generator=gen, device=dev, dtype=torch.bfloat16)
        return w * torch.tensor(0.02, dtype=torch.bfloat16, device=dev)

    def ones(n):
        return torch.ones((n,), dtype=torch.bfloat16, device=dev)

    shapes = {
        "self_attn.q_proj": (cfg.q_size, cfg.hidden_size),
        "self_attn.k_proj": (cfg.kv_size, cfg.hidden_size),
        "self_attn.v_proj": (cfg.kv_size, cfg.hidden_size),
        "self_attn.o_proj": (cfg.hidden_size, cfg.q_size),
        "mlp.gate_proj": (cfg.intermediate_size, cfg.hidden_size),
        "mlp.up_proj": (cfg.intermediate_size, cfg.hidden_size),
        "mlp.down_proj": (cfg.hidden_size, cfg.intermediate_size),
    }
    layers = []
    for _ in range(cfg.num_layers):
        lp = {"input_layernorm": {"weight": ones(cfg.hidden_size)},
              "post_attention_layernorm": {"weight": ones(cfg.hidden_size)},
              "self_attn": {}, "mlp": {}}
        for name, (out_f, in_f) in shapes.items():
            set_nested(lp, name, packed(out_f, in_f, 1.0 / in_f ** 0.5, spec))
        if cfg.qk_norm:
            lp["self_attn"]["q_norm"] = {"weight": ones(cfg.head_dim)}
            lp["self_attn"]["k_norm"] = {"weight": ones(cfg.head_dim)}
        layers.append(lp)
    params = {"model": {"embed_tokens": {"weight": dense(cfg.vocab_size, cfg.hidden_size)},
                        "layers": layers,
                        "norm": {"weight": ones(cfg.hidden_size)}}}
    if not cfg.tie_word_embeddings:
        if lm_head_bits < 16:
            head_spec = QuantSpec(bits=lm_head_bits, group_size=spec.group_size, sym=False)
            params["lm_head"] = pad_out(packed(cfg.vocab_size, cfg.hidden_size, 0.02,
                                               head_spec))
        else:
            params["lm_head"] = {"w": dense(cfg.vocab_size, cfg.hidden_size)}
    return params
