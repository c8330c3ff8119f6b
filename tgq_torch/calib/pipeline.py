"""Layer-sequential calibration + quantization (mirrors
``tgq/calib/pipeline.py``, without the mesh, resume and spectral-check
paths).

- The pipeline calls the decoder-layer pieces (attn_input / attn_core /
  mlp_input / mlp_act) to get each quantization group's input directly.
- Hessians accumulate on the device; pchol factorizes on the device
  (eigh / gptq / svd on the host in f64); the blockwise GPTQ loop runs on
  the device.
- One layer at a time moves to the device and back.
- Calibration activations are re-forwarded through the quantized layer
  to feed the next layer.
- The results log keeps the reference schema
  ({config, layer_stats:[{name, rank, time, rel_error}], metrics}).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Optional

import numpy as np
import torch

from tgq_torch.core.packing import PackedLinear
from tgq_torch.core.quant import QuantSpec, expand_params, find_params, quantize
from tgq_torch.models.causal_lm import (
    Params,
    attn_core,
    attn_input,
    attn_out_proj,
    decoder_layer,
    get_nested,
    mlp_act,
    mlp_input,
    mlp_out_proj,
    rope_cache,
    sequenced_groups,
    set_nested,
    tree_to,
)
from tgq_torch.models.config import ModelConfig
from tgq_torch.solver.factorize import (
    FactorResult,
    gptq_cholesky_factor,
    sketch_factor,
    trunc_spectral_factor,
)
from tgq_torch.solver.gptq_loop import quantize_weight, rel_error
from tgq_torch.solver.hessian import HessianAccumulator, SketchAccumulator
from tgq_torch.solver.pchol import pchol_factor
from tgq_torch.utils.precision import resolve_device
from tgq_torch.utils.profiling import PhaseTimers

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class QuantizeConfig:
    """Solver/pipeline flags, names and defaults as the JAX package's."""

    mode: str = "eigh"            # eigh | pchol | gptq | svd | rtn
    w_bits: int = 4
    group_size: int = 128
    sym: bool = False
    eps: float = 1e-2
    threshold_method: str = "mean_trimmed"
    actorder: bool = False
    damp_percent: float = 0.01
    adaptive_eps: bool = False
    sketch_ratio: float = 4.0
    batch_size: int = 8
    block_size: int = 256
    kernel_backend: str = "kernel"  # kernel (CUDA kernels) | plain
    precision: str = "f64"        # eigh factorization: f64 (host) | f32 (device)
    attn_impl: str = "auto"
    pack: bool = True             # also collect the packed INT export
    log_rel_error: bool = True    # per-module relative prediction error
    seed: int = 42

    @property
    def spec(self) -> QuantSpec:
        return QuantSpec(bits=self.w_bits, group_size=self.group_size, sym=self.sym)


def get_adaptive_eps(layer_name: str, base_eps: float) -> float:
    """ε×0.1 for the sensitive projections."""
    if any(x in layer_name for x in
           ("down_proj", "o_proj", "c_proj", "out_proj", "fc2")):
        return base_eps * 0.1
    return base_eps


def _group_in_features(cfg: ModelConfig, gi: int) -> int:
    return [cfg.hidden_size, cfg.q_size, cfg.hidden_size, cfg.intermediate_size][gi]


# Staged single-pass forwards: each stage of the decoder layer runs once
# per calibration batch and its output is reused as the next group's
# input and the next stage's operand.


def _stage_attn(lp, cfg, x, cos, sin, attn_impl="auto"):
    """Attention output (group 1's input), with group-0-quantized q/k/v."""
    return attn_core(lp, cfg, attn_input(lp, cfg, x), cos, sin, attn_impl=attn_impl)


def _stage_resid(lp, cfg, x, attn):
    """x2: the post-attention residual (with group-1-quantized o_proj)."""
    return x + attn_out_proj(lp, cfg, attn)


def _stage_act(lp, cfg, x2):
    """silu(gate)·up (group 3's input), with group-2-quantized gate/up."""
    return mlp_act(lp, cfg, mlp_input(lp, cfg, x2))


def _stage_act_t(lp, cfg, x2):
    """Group 3's input in the transposed (ff, T) orientation, for the
    token-minor Gram of ``HessianAccumulator.update_t``
    (``tgq/calib/pipeline.py:165-187``): bf16 silu(gate)·up."""
    h2 = mlp_input(lp, cfg, x2).reshape(-1, cfg.hidden_size)       # (T, d)
    gate = lp["mlp"]["gate_proj"]["w"] @ h2.T                        # (ff, T)
    up = lp["mlp"]["up_proj"]["w"] @ h2.T
    return torch.nn.functional.silu(gate) * up


def _stage_out(lp, cfg, x2):
    """Quantized-layer output from the staged residual."""
    return x2 + mlp_out_proj(lp, cfg, mlp_act(lp, cfg, mlp_input(lp, cfg, x2)))


def _factorize(h_or_y, qcfg: QuantizeConfig, eps: float) -> FactorResult:
    if qcfg.mode == "eigh":
        return trunc_spectral_factor(h_or_y, eps=eps, method=qcfg.threshold_method,
                                     precision=qcfg.precision)
    if qcfg.mode == "gptq":
        return gptq_cholesky_factor(h_or_y, actorder=qcfg.actorder,
                                    damp_percent=qcfg.damp_percent)
    if qcfg.mode == "svd":
        return sketch_factor(h_or_y, eps=eps, method=qcfg.threshold_method)
    if qcfg.mode == "pchol":
        return pchol_factor(h_or_y, eps=eps, want_rx=qcfg.log_rel_error,
                            backend=qcfg.kernel_backend)
    raise ValueError(f"no factorization for mode {qcfg.mode!r}")


def _rtn_quantize(w: torch.Tensor, spec: QuantSpec):
    p = find_params(w, spec)
    s, z = expand_params(p, w.shape[1])
    codes = quantize(w, s, z, spec)
    return codes.to(torch.int32), (codes - z) * s, p


@torch.no_grad()
def quantize_layer(lp: Params, cfg: ModelConfig, inps: torch.Tensor, cos, sin,
                   qcfg: QuantizeConfig, timers: Optional[PhaseTimers] = None,
                   name_prefix: str = ""):
    """Quantize one decoder layer's four sequential groups.

    Returns (lp, outs, module_stats, packed): outs are the quantized
    layer's outputs for every calibration batch (the next layer's
    inputs), module_stats the reference layer_stats schema (plus the RTN
    error of the same weight under the same metric, ``rtn_rel_error``),
    packed maps module path → PackedLinear (empty unless qcfg.pack).
    """
    timers = timers or PhaseTimers()
    n_samples = inps.shape[0]
    bs = qcfg.batch_size
    spec = qcfg.spec
    idx = list(range(0, n_samples, bs))
    staged = qcfg.mode != "rtn"  # rtn needs no activations
    attn_l = x2_l = None
    module_stats: list[dict[str, Any]] = []
    packed: dict[str, PackedLinear] = {}

    for gi, group_names in enumerate(sequenced_groups(cfg)):
        eps = (get_adaptive_eps(group_names[0], qcfg.eps)
               if qcfg.adaptive_eps else qcfg.eps)
        in_f = _group_in_features(cfg, gi)

        if staged and gi == 1:
            with timers.phase("stage_fwd"):
                attn_l = [_stage_attn(lp, cfg, inps[j : j + bs], cos, sin,
                                      attn_impl=qcfg.attn_impl) for j in idx]
        elif staged and gi == 2:
            with timers.phase("stage_fwd"):
                x2_l = [_stage_resid(lp, cfg, inps[j : j + bs], attn_l[jj])
                        for jj, j in enumerate(idx)]
                attn_l = None

        def group_act(jj: int, j: int):
            if gi == 0:
                return attn_input(lp, cfg, inps[j : j + bs])
            if gi == 1:
                return attn_l[jj]
            if gi == 2:
                return mlp_input(lp, cfg, x2_l[jj])
            return _stage_act(lp, cfg, x2_l[jj])

        stats = None
        if staged:
            if qcfg.mode == "svd":
                acc = SketchAccumulator.init(in_f, rank=int(in_f * qcfg.sketch_ratio),
                                             seed=qcfg.seed, device=inps.device)
            else:
                acc = HessianAccumulator.init(in_f, device=inps.device)
            fused_t = (gi == 3 and qcfg.mode != "svd"
                       and "b" not in get_nested(lp, "mlp.gate_proj"))
            with timers.phase("accumulate"):
                for jj, j in enumerate(idx):
                    if fused_t:
                        acc.update_t(_stage_act_t(lp, cfg, x2_l[jj]))
                    else:
                        acc.update(group_act(jj, j))
                h_or_y = acc.finalize()
            del acc
            t_f = time.time()
            with timers.phase("factorize"):
                stats = _factorize(h_or_y, qcfg, eps)
            logger.info("   factorized %s in %.2fs (rank %d/%d)",
                        tuple(h_or_y.shape), time.time() - t_f, stats.rank, in_f)
            del h_or_y

        for name in group_names:
            t_solve = time.time()
            old = get_nested(lp, name)
            w = old["w"].float()
            rtn_rel = float("nan")
            with timers.phase("quantize"):
                if stats is None:
                    codes, wq, p = _rtn_quantize(w, spec)
                    rank, rel = w.shape[1], float("nan")
                    scale, zero = p.scale, p.zero
                else:
                    res = quantize_weight(w, stats, spec, block_size=qcfg.block_size,
                                          backend=qcfg.kernel_backend,
                                          with_error=qcfg.log_rel_error)
                    codes, wq = res.codes, res.w_q
                    scale, zero = res.scale, res.zero
                    # rel errors stay device scalars until the layer-end flush
                    rank, rel = stats.rank, res.rel_error
                    if qcfg.log_rel_error and stats.r_x is not None:
                        rtn_rel = rel_error(
                            w, _rtn_quantize(w, spec)[1],
                            torch.as_tensor(stats.perm, device=w.device).long(),
                            torch.as_tensor(stats.r_x, device=w.device).float())
            new_p = dict(old)
            new_p["w"] = wq.to(torch.bfloat16)
            set_nested(lp, name, new_p)
            if qcfg.pack:
                packed[name] = PackedLinear.from_codes(
                    codes, scale, zero, spec,
                    bias=old["b"].float() if "b" in old else None)
            module_stats.append(
                {"name": f"{name_prefix}{name}", "rank": int(rank),
                 "time": time.time() - t_solve, "rel_error": rel,
                 "rtn_rel_error": rtn_rel})

    with timers.phase("reforward"):
        if x2_l is not None:
            outs = [_stage_out(lp, cfg, x2) for x2 in x2_l]
        else:  # rtn never staged
            outs = [decoder_layer(lp, cfg, inps[j : j + bs], cos, sin,
                                  attn_impl=qcfg.attn_impl) for j in idx]
    for m in module_stats:
        m["rel_error"] = float(m["rel_error"])
        m["rtn_rel_error"] = float(m["rtn_rel_error"])
        logger.info("   %-22s | rank %5s | rel_err %.4f | %.2fs",
                    m["name"], m["rank"], m["rel_error"], m["time"])
    return lp, outs, module_stats, packed


@torch.no_grad()
def quantize_model(params: Params, cfg: ModelConfig, input_ids: np.ndarray,
                   qcfg: QuantizeConfig, device: str = "cuda",
                   resume_dir: Optional[str] = None,
                   stop_after_layer: Optional[int] = None,
                   timers: Optional[PhaseTimers] = None,
                   ) -> tuple[Params, dict[str, PackedLinear], dict[str, Any]]:
    """Quantize every decoder layer in place (layer-sequential).

    ``params`` may live on the host or the device; each layer moves to
    ``device`` for its turn and back to where it was.  Returns (params,
    packed export keyed by "layers.<i>.<path>", experiment log).
    """
    if resume_dir is not None:
        raise NotImplementedError("per-layer resume is slice 3 (ROADMAP.md)")
    if qcfg.kernel_backend not in ("kernel", "plain"):
        raise ValueError(f"unknown kernel_backend {qcfg.kernel_backend!r}")
    dev = resolve_device(device)
    timers = timers or PhaseTimers()
    n_samples, seq_len = input_ids.shape
    bs = qcfg.batch_size
    log: dict[str, Any] = {
        "config": dataclasses.asdict(qcfg) | {"model": cfg.name},
        "layer_stats": [],
        "metrics": {},
    }
    packed: dict[str, PackedLinear] = {}
    groups = sequenced_groups(cfg)
    cos, sin = rope_cache(cfg, seq_len, device=dev)

    t_start = time.time()
    embed_w = params["model"]["embed_tokens"]["weight"].to(dev)
    ids_all = torch.from_numpy(np.asarray(input_ids, np.int64)).to(dev)
    inps = torch.cat([embed_w[ids_all[j : j + bs]].to(torch.bfloat16)
                      for j in range(0, n_samples, bs)])
    del embed_w, ids_all
    logger.info("[calib] captured %d sequences of %d tokens", n_samples, seq_len)

    n_layers = len(params["model"]["layers"])
    for li in range(n_layers):
        layer_t0 = time.time()
        logger.info("[layer %d/%d] groups: %s", li + 1, n_layers,
                    " | ".join(",".join(g) for g in groups))
        host_layer = params["model"]["layers"][li]
        home = host_layer["input_layernorm"]["weight"].device
        lp = tree_to(host_layer, dev)
        lp, outs, module_stats, layer_packed = quantize_layer(
            lp, cfg, inps, cos, sin, qcfg, timers=timers, name_prefix=f"layer_{li}.")
        log["layer_stats"].extend(module_stats)
        for name, pl in layer_packed.items():
            packed[f"layers.{li}.{name}"] = pl
        inps = torch.cat(outs, dim=0)
        del outs
        params["model"]["layers"][li] = tree_to(lp, home)
        del lp
        logger.info("[*] layer %d/%d done in %.2fs", li + 1, n_layers, time.time() - layer_t0)
        if stop_after_layer is not None and li >= stop_after_layer:
            logger.info("[*] stopping after layer %d as requested", li)
            break

    log["metrics"]["total_time"] = time.time() - t_start
    log["metrics"]["phase_timing"] = timers.summary()
    timers.log_summary()
    return params, packed, log
