"""OPT family: the ``model.decoder.layers`` layout (mirrors
``tgq/models/opt.py``).

LayerNorm with bias, unfused biased q/k/v/out projections, MHA, learned
position embeddings with the HF OPT +2 offset (no rope), and a ReLU
fc1 → fc2 MLP.  The four sequential quantization groups are
[q,k,v_proj] → [out_proj] → [fc1] → [fc2].

Tree layout (``hf_import`` maps ``model.decoder.*`` here; OPT projections
are nn.Linear (out, in), so nothing is transposed):

  model.embed_tokens.weight      (decoder.embed_tokens)
  model.wpe.weight               (decoder.embed_positions; rows 0..1
                                  are the HF offset padding)
  model.layers[i].self_attn_layer_norm.{weight,bias}
  model.layers[i].self_attn.{q,k,v,out}_proj  {"w", "b"}
  model.layers[i].final_layer_norm.{weight,bias}
  model.layers[i].fc1  {"w": (4h, h), "b"}
  model.layers[i].fc2  {"w": (h, 4h), "b"}
  model.norm.{weight,bias}       (decoder.final_layer_norm)

Pre-norm variants with word_embed_proj_dim == hidden_size only; OPT-350m
(post-norm, project_in/out) is refused at import.
"""
from __future__ import annotations

import torch

from tgq_torch.models.config import ModelConfig
from tgq_torch.models.gpt2 import layer_norm
from tgq_torch.parallel.mesh import all_gather_last, tp_mesh
from tgq_torch.utils.precision import resolve_device

Params = dict

_POS_OFFSET = 2  # HF OPTLearnedPositionalEmbedding: positions + 2


def opt_embed(params: Params, input_ids: torch.Tensor,
              dtype=torch.bfloat16) -> torch.Tensor:
    """wte[ids] + wpe[positions + 2]."""
    wte = params["model"]["embed_tokens"]["weight"]
    wpe = params["model"]["wpe"]["weight"]
    seq = input_ids.shape[-1]
    return (wte[input_ids] + wpe[_POS_OFFSET:_POS_OFFSET + seq][None]).to(dtype)


def opt_attn_input(lp: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """self_attn_layer_norm(x): the q/k/v (group 0) input."""
    n = lp["self_attn_layer_norm"]
    return layer_norm(x, n["weight"], n["bias"], cfg.rms_norm_eps)


def opt_attn_core(lp: Params, cfg: ModelConfig, h: torch.Tensor,
                  attn_impl: str = "auto") -> torch.Tensor:
    """q/k/v through causal attention (no rope); returns the out_proj
    (group 1) input, shape (batch, seq, hidden).  Under a TP mesh the rank
    holds its heads' q/k/v (``cfg`` its local config); out_proj is
    replicated, so the heads are gathered here, the one gather of them."""
    from tgq_torch.models.causal_lm import apply_linear, causal_attention

    b, s, _ = h.shape
    shape = (b, s, cfg.num_heads, cfg.head_dim)
    q = apply_linear(lp["self_attn"]["q_proj"], h).reshape(shape)
    k = apply_linear(lp["self_attn"]["k_proj"], h).reshape(shape)
    v = apply_linear(lp["self_attn"]["v_proj"], h).reshape(shape)
    attn = causal_attention(q, k, v, impl=attn_impl).reshape(b, s, -1)
    mesh = tp_mesh()
    return attn if mesh is None else all_gather_last(attn, mesh, "model")


def opt_attn_out(lp: Params, cfg: ModelConfig, attn: torch.Tensor) -> torch.Tensor:
    from tgq_torch.models.causal_lm import apply_linear

    return apply_linear(lp["self_attn"]["out_proj"], attn)


def opt_mlp_input(lp: Params, cfg: ModelConfig, x2: torch.Tensor) -> torch.Tensor:
    """final_layer_norm(x2): the fc1 (group 2) input."""
    n = lp["final_layer_norm"]
    return layer_norm(x2, n["weight"], n["bias"], cfg.rms_norm_eps)


def opt_mlp_act(lp: Params, cfg: ModelConfig, h2: torch.Tensor) -> torch.Tensor:
    """relu(fc1(h2)): the fc2 (group 3) input."""
    from tgq_torch.models.causal_lm import apply_linear

    return torch.relu(apply_linear(lp["fc1"], h2))


def opt_mlp_out(lp: Params, cfg: ModelConfig, act: torch.Tensor) -> torch.Tensor:
    from tgq_torch.models.causal_lm import apply_linear

    return apply_linear(lp["fc2"], act)


def opt_final_norm(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    n = params["model"]["norm"]
    return layer_norm(x, n["weight"], n["bias"], cfg.rms_norm_eps)


def opt_sequenced_groups(cfg: ModelConfig) -> list[list[str]]:
    """Four sequential quantization groups sharing one Hessian each."""
    return [
        ["self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"],
        ["self_attn.out_proj"],
        ["fc1"],
        ["fc2"],
    ]


def init_opt_params(cfg: ModelConfig, seed: int = 0, device: str = "cuda",
                    dtype=torch.bfloat16) -> Params:
    """Random init with the JAX package's scales, from ``seed`` (the
    numbers are ``torch.Generator``'s, not ``jax.random``'s)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        return w * torch.tensor(scale, dtype=dtype, device=dev)

    def dense(out_f, in_f):
        return {"w": normal((out_f, in_f), 1.0 / in_f ** 0.5),
                "b": torch.zeros((out_f,), dtype=dtype, device=dev)}

    def ln(n):
        return {"weight": torch.ones((n,), dtype=dtype, device=dev),
                "bias": torch.zeros((n,), dtype=dtype, device=dev)}

    h = cfg.hidden_size
    layers = [{
        "self_attn_layer_norm": ln(h),
        "self_attn": {"q_proj": dense(h, h), "k_proj": dense(h, h),
                      "v_proj": dense(h, h), "out_proj": dense(h, h)},
        "final_layer_norm": ln(h),
        "fc1": dense(cfg.intermediate_size, h),
        "fc2": dense(h, cfg.intermediate_size),
    } for _ in range(cfg.num_layers)]
    return {"model": {
        "embed_tokens": {"weight": normal((cfg.vocab_size, h), 0.02)},
        "wpe": {"weight": normal((cfg.max_position_embeddings + _POS_OFFSET, h), 0.01)},
        "layers": layers,
        "norm": ln(h),
    }}
