"""Layer-sequential calibration + quantization (mirrors
``tgq/calib/pipeline.py``, without the mesh path).

- The pipeline calls the decoder-layer pieces (attn_input / attn_core /
  mlp_input / mlp_act, per model family) to get each quantization group's
  input directly.
- Hessians accumulate on the device; pchol factorizes on the device
  (eigh / gptq / svd on the host in f64); the blockwise GPTQ loop runs on
  the device.
- One layer at a time moves to the device and back.
- Calibration activations are re-forwarded through the quantized layer
  to feed the next layer.
- With a resume directory every finished layer is saved (the JAX
  package's file layout), and a re-run restores the finished prefix.
- The results log keeps the reference schema
  ({config, layer_stats:[{name, rank, time, rel_error}], metrics}).
- ``spectral_consistency_check`` is the CLI's ``--mode test``.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
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
    embed_tokens,
    get_nested,
    glu_act,
    mlp_act,
    mlp_input,
    mlp_out_proj,
    rope_cache,
    sequenced_groups,
    set_nested,
    tree_to,
)
from tgq_torch.models.config import ModelConfig
from tgq_torch.models.convert import numpy_from_tensor, tensor_from_numpy
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
    return glu_act(gate, up)


def _stage_out(lp, cfg, x2):
    """Quantized-layer output from the staged residual."""
    return x2 + mlp_out_proj(lp, cfg, mlp_act(lp, cfg, mlp_input(lp, cfg, x2)))


def _layer_forward_staged(lp, cfg, x, cos, sin, attn_impl="auto"):
    """A full layer forward through the same staged functions
    ``quantize_layer`` takes its outputs from: bit-identical to an
    uninterrupted run's propagated activations, which resume relies on."""
    attn = _stage_attn(lp, cfg, x, cos, sin, attn_impl=attn_impl)
    return _stage_out(lp, cfg, _stage_resid(lp, cfg, x, attn))


def _group_input(lp, cfg, gi: int, x, cos, sin, attn_impl="auto"):
    """Activation feeding quantization group ``gi`` of one decoder layer,
    from the layer's input (the whole prefix recomputed)."""
    if gi == 0:
        return attn_input(lp, cfg, x)
    attn = _stage_attn(lp, cfg, x, cos, sin, attn_impl=attn_impl)
    if gi == 1:
        return attn
    x2 = _stage_resid(lp, cfg, x, attn)
    return mlp_input(lp, cfg, x2) if gi == 2 else _stage_act(lp, cfg, x2)


def _embed_batches(params, cfg, input_ids: np.ndarray, bs: int, dev) -> torch.Tensor:
    """The calibration tokens' embeddings (learned positions included for
    gpt2/opt), embedded ``bs`` sequences at a time on ``dev``."""
    emb = {"model": {k: tree_to(params["model"][k], dev)
                     for k in ("embed_tokens", "wpe") if k in params["model"]}}
    ids = torch.from_numpy(np.asarray(input_ids, np.int64)).to(dev)
    return torch.cat([embed_tokens(emb, ids[j : j + bs], cfg=cfg)
                      for j in range(0, ids.shape[0], bs)])


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
                   name_prefix: str = "", attn: Optional[list[torch.Tensor]] = None):
    """Quantize one decoder layer's four sequential groups.

    ``attn``: group 1's inputs, one (batch, seq, q_size) tensor per
    calibration batch, used in place of the attention this layer computes
    (a test gives the JAX package's, to isolate the attention's numerics).

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
                attn_l = attn or [_stage_attn(lp, cfg, inps[j : j + bs], cos, sin,
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
            fused_t = (gi == 3 and cfg.family == "llama" and qcfg.mode != "svd"
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


def _save_resume_layer(resume_dir: str, li: int, layer: Params,
                       packed: dict[str, PackedLinear], log: dict) -> None:
    """Save one finished layer (its written-back weights, its packed
    linears and its layer_stats) and advance ``progress.json``, each file
    replaced atomically.  The layout is the JAX package's: ``layer_<i>.npz``
    with bf16 leaves as ``__bf16__<path>`` uint16 bits and packed linears as
    ``__packed_export__layers.<i>.<path>.{codes,scale,zero,bias,__packed__}``."""
    os.makedirs(resume_dir, exist_ok=True)
    flat: dict[str, np.ndarray] = {}

    def walk(node, prefix=""):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(node, PackedLinear):
            for leaf in ("codes", "scale", "zero", "bias"):
                if getattr(node, leaf) is not None:
                    flat[f"{prefix}{leaf}"] = numpy_from_tensor(getattr(node, leaf))
            flat[f"{prefix}__packed__"] = np.asarray(
                [node.bits, node.group_size, node.in_features, node.out_features])
        elif node.dtype == torch.bfloat16:
            flat[f"__bf16__{prefix[:-1]}"] = numpy_from_tensor(node)
        else:
            flat[prefix[:-1]] = numpy_from_tensor(node)

    walk(layer)
    for key, pl in packed.items():
        if key.startswith(f"layers.{li}."):
            walk(pl, f"__packed_export__{key}.")
    tmp = os.path.join(resume_dir, f"layer_{li}.tmp.npz")
    np.savez(tmp, **flat)
    os.replace(tmp, os.path.join(resume_dir, f"layer_{li}.npz"))
    prog_path = os.path.join(resume_dir, "progress.json")
    done = {}
    if os.path.exists(prog_path):
        with open(prog_path) as f:
            done = json.load(f)
    done[str(li)] = [s for s in log["layer_stats"] if s["name"].startswith(f"layer_{li}.")]
    with open(prog_path + ".tmp", "w") as f:
        json.dump(done, f)
    os.replace(prog_path + ".tmp", prog_path)


def _tree_device(tree) -> torch.device:
    """The device of a parameter tree's first tensor."""
    while isinstance(tree, (dict, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.codes.device if isinstance(tree, PackedLinear) else tree.device


def _insert(root: dict, dotted: str, value) -> None:
    parts = dotted.split(".")
    for p in parts[:-1]:
        root = root.setdefault(p, {})
    root[parts[-1]] = value


def _load_resume(resume_dir: str, params: Params, packed: dict, log: dict,
                 n_layers: int) -> int:
    """Restore the longest finished prefix of layers (each onto the device
    its layer lives on); returns the first layer still to do."""
    prog_path = os.path.join(resume_dir, "progress.json")
    if not os.path.exists(prog_path):
        return 0
    with open(prog_path) as f:
        done = json.load(f)
    start = 0
    while (start < n_layers and str(start) in done
           and os.path.exists(os.path.join(resume_dir, f"layer_{start}.npz"))):
        home = _tree_device(params["model"]["layers"][start])
        with np.load(os.path.join(resume_dir, f"layer_{start}.npz")) as data:
            arrays = dict(data)
        layer: dict = {}
        groups: dict[str, dict] = {}
        for name, arr in arrays.items():
            if name.startswith("__packed_export__"):
                base, leaf = name[len("__packed_export__"):].rsplit(".", 1)
                groups.setdefault(base, {})[leaf] = arr
            elif name.startswith("__bf16__"):
                _insert(layer, name[len("__bf16__"):],
                        tensor_from_numpy(arr, home, bf16_bits=True))
            else:
                _insert(layer, name, tensor_from_numpy(arr, home))
        params["model"]["layers"][start] = layer
        for base, parts in groups.items():
            bits, gs, in_f, out_f = (int(x) for x in parts["__packed__"])
            bias = parts.get("bias")
            packed[base] = PackedLinear(
                codes=tensor_from_numpy(parts["codes"], home),
                scale=tensor_from_numpy(parts["scale"], home),
                zero=tensor_from_numpy(parts["zero"], home),
                bits=bits, group_size=gs, in_features=in_f, out_features=out_f,
                bias=None if bias is None else tensor_from_numpy(bias, home))
        log["layer_stats"].extend(done[str(start)])
        start += 1
    return start


@torch.no_grad()
def spectral_consistency_check(params: Params, cfg: ModelConfig, input_ids: np.ndarray,
                               qcfg: QuantizeConfig, max_layers: int = 1,
                               device: str = "cuda") -> list[dict]:
    """The reference's mode "test": for each group of the first
    ``max_layers`` layers, sqrt(λ_max(H)) (H's eigenvalues in f64 on the
    host) against the sketch's top singular value — a check that the
    randomized sketch sees the Hessian's spectrum.  One record a group."""
    dev = resolve_device(device)
    n_samples, seq_len = input_ids.shape
    bs = qcfg.batch_size
    cos, sin = rope_cache(cfg, seq_len, device=dev)
    inps = _embed_batches(params, cfg, input_ids, bs, dev)
    records = []
    for li in range(min(max_layers, len(params["model"]["layers"]))):
        lp = tree_to(params["model"]["layers"][li], dev)
        for gi, group_names in enumerate(sequenced_groups(cfg)):
            in_f = _group_in_features(cfg, gi)
            acc_h = HessianAccumulator.init(in_f, device=dev)
            acc_s = SketchAccumulator.init(in_f, rank=int(in_f * qcfg.sketch_ratio),
                                           seed=qcfg.seed, device=dev)
            for j in range(0, n_samples, bs):
                a = _group_input(lp, cfg, gi, inps[j : j + bs], cos, sin,
                                 attn_impl=qcfg.attn_impl)
                acc_h.update(a)
                acc_s.update(a)
            h = acc_h.finalize().cpu().double().numpy()
            y = acc_s.finalize().cpu().double().numpy()
            h_max_sqrt = float(np.sqrt(max(np.linalg.eigvalsh(h)[-1], 0.0)))
            y_max_sv = float(np.linalg.svd(y, compute_uv=False)[0])
            rec = {"name": f"layer_{li}.{group_names[0]}",
                   "sqrt_max_eig_H": h_max_sqrt, "max_sv_Y": y_max_sv,
                   "ratio": h_max_sqrt / y_max_sv if y_max_sv else float("inf")}
            logger.info("spectral check %s: sqrt(λmax)=%.4f max_sv=%.4f ratio=%.4f",
                        rec["name"], h_max_sqrt, y_max_sv, rec["ratio"])
            records.append(rec)
    return records


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

    ``resume_dir``: every finished layer is saved there, and a re-run with
    the same directory restores the finished prefix and re-forwards the
    calibration activations through it, so a killed sweep loses at most
    one layer.  ``stop_after_layer`` ends the sweep after that layer.
    """
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
    inps = _embed_batches(params, cfg, input_ids, bs, dev)
    logger.info("[calib] captured %d sequences of %d tokens", n_samples, seq_len)

    n_layers = len(params["model"]["layers"])
    start_layer = 0
    if resume_dir is not None:
        start_layer = _load_resume(resume_dir, params, packed, log, n_layers)
        if start_layer:
            logger.info("[resume] layers 0..%d restored; re-forwarding the "
                        "calibration activations", start_layer - 1)
            refwd = decoder_layer if qcfg.mode == "rtn" else _layer_forward_staged
            for li in range(start_layer):
                lp = tree_to(params["model"]["layers"][li], dev)
                inps = torch.cat([refwd(lp, cfg, inps[j : j + bs], cos, sin,
                                        attn_impl=qcfg.attn_impl)
                                  for j in range(0, n_samples, bs)])
                del lp
    for li in range(start_layer, n_layers):
        layer_t0 = time.time()
        logger.info("[layer %d/%d] groups: %s", li + 1, n_layers,
                    " | ".join(",".join(g) for g in groups))
        host_layer = params["model"]["layers"][li]
        home = _tree_device(host_layer)
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
        if resume_dir is not None:
            _save_resume_layer(resume_dir, li, params["model"]["layers"][li], packed, log)
        logger.info("[*] layer %d/%d done in %.2fs", li + 1, n_layers, time.time() - layer_t0)
        if stop_after_layer is not None and li >= stop_after_layer:
            logger.info("[*] stopping after layer %d as requested", li)
            break

    log["metrics"]["total_time"] = time.time() - t_start
    log["metrics"]["phase_timing"] = timers.summary()
    timers.log_summary()
    return params, packed, log
