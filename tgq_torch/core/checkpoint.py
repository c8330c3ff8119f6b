"""Packed-INT checkpoint format (mirrors ``tgq/core/checkpoint.py``).

A checkpoint directory holds ``weights.npz`` (+ ``layer_%03d.npz`` shards)
and ``config.json``, with the JAX package's array names: packed linears
as ``<path>.codes/.scale/.zero/.bias/.__packed__``, bf16 leaves as
``__bf16__<path>`` uint16 bit views, KV equalizers as ``__kv_eq__k/v``.
A checkpoint written by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch

from tgq_torch.core.packing import PackedLinear
from tgq_torch.models.config import ModelConfig
from tgq_torch.models.convert import numpy_from_tensor, tensor_from_numpy
from tgq_torch.utils.precision import resolve_device

PACK_LAYOUT_VERSION = 2  # 2 = int3 "planes21"


def _np(x) -> np.ndarray:
    return numpy_from_tensor(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _flatten(tree: Any, prefix: str = "") -> dict[str, tuple[np.ndarray, bool]]:
    """name -> (array, is_bf16)."""
    out: dict[str, tuple[np.ndarray, bool]] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}."))
    elif isinstance(tree, PackedLinear):
        out[f"{prefix}codes"] = (_np(tree.codes), False)
        out[f"{prefix}scale"] = (_np(tree.scale), False)
        out[f"{prefix}zero"] = (_np(tree.zero), False)
        if tree.bias is not None:
            out[f"{prefix}bias"] = (_np(tree.bias), False)
        out[f"{prefix}__packed__"] = (np.asarray(
            [tree.bits, tree.group_size, tree.in_features, tree.out_features]), False)
    else:
        is_bf16 = isinstance(tree, torch.Tensor) and tree.dtype == torch.bfloat16
        out[prefix.rstrip(".")] = (_np(tree), is_bf16)
    return out


def save_quantized(path: str, params: Any, packed: dict[str, PackedLinear],
                   cfg: ModelConfig, qconfig: dict | None = None,
                   kv_equalizers: tuple | None = None,
                   shard_layers: bool = False) -> None:
    """Write a packed checkpoint directory: weights.npz + config.json.

    ``params`` supplies the non-quantized leaves; packed entries replace
    the dense weights of their layer paths.  ``shard_layers`` writes one
    ``layer_%03d.npz`` per decoder layer next to the base archive."""
    os.makedirs(path, exist_ok=True)
    flat: dict[str, np.ndarray] = {}
    if kv_equalizers is not None:
        k_eq, v_eq = kv_equalizers
        flat["__kv_eq__k"] = np.asarray(_np(k_eq), np.float32)
        flat["__kv_eq__v"] = np.asarray(_np(v_eq), np.float32)
    packed_prefixes = {f"model.{k}" for k in packed}
    for name, (arr, is_bf16) in _flatten(params).items():
        if any(name.startswith(p + ".") for p in packed_prefixes):
            continue
        flat[f"__bf16__{name}" if is_bf16 else name] = arr
    for key, pl in packed.items():
        flat.update({k: a for k, (a, _) in _flatten(pl, f"model.{key}.").items()})

    n_shards = 0
    if shard_layers:
        per_layer: dict[int, dict[str, np.ndarray]] = {}
        base: dict[str, np.ndarray] = {}
        for name, arr in flat.items():
            bf16 = name.startswith("__bf16__")
            parts = (name[len("__bf16__"):] if bf16 else name).split(".")
            if (len(parts) > 3 and parts[0] == "model"
                    and parts[1] == "layers" and parts[2].isdigit()):
                rel = ".".join(parts[3:])
                per_layer.setdefault(int(parts[2]), {})[
                    f"__bf16__{rel}" if bf16 else rel] = arr
            else:
                base[name] = arr
        n_shards = max(per_layer) + 1 if per_layer else 0
        for li, shard in per_layer.items():
            np.savez(os.path.join(path, f"layer_{li:03d}.npz"), **shard)
        flat = base
    np.savez(os.path.join(path, "weights.npz"), **flat)
    meta = {"model_config": dataclasses.asdict(cfg),
            "quant_config": qconfig or {},
            "pack_layout": PACK_LAYOUT_VERSION}
    if n_shards:
        meta["layer_shards"] = n_shards
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(meta, f, indent=2)


def _insert(tree, dotted, value):
    parts = dotted.split(".")
    cur = tree
    for i, p in enumerate(parts[:-1]):
        nxt = parts[i + 1]
        if p.isdigit():
            p = int(p)
        if isinstance(cur, list):
            while len(cur) <= p:
                cur.append({})
            if not cur[p]:
                cur[p] = [] if nxt.isdigit() else {}
            cur = cur[p]
        else:
            if p not in cur or not cur[p]:
                cur[p] = [] if nxt.isdigit() else {}
            cur = cur[p]
    last = parts[-1]
    last = int(last) if last.isdigit() else last
    if isinstance(cur, list):
        while len(cur) <= last:
            cur.append(None)
    cur[last] = value


def _decode_arrays(data: dict, tree: dict, kv_eq: dict, device) -> None:
    """Regroup one npz's arrays into ``tree`` as tensors (PackedLinear
    groups reassembled, __bf16__ views restored, __kv_eq__ split out)."""
    packed_groups: dict[str, dict[str, np.ndarray]] = {}
    plain: dict[str, torch.Tensor] = {}
    for name, arr in data.items():
        if name.startswith("__kv_eq__"):
            kv_eq[name[len("__kv_eq__"):]] = arr
            continue
        if name.startswith("__bf16__"):
            plain[name[len("__bf16__"):]] = tensor_from_numpy(arr, device, bf16_bits=True)
            continue
        base, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        if leaf in ("codes", "scale", "zero", "bias", "__packed__") and base:
            packed_groups.setdefault(base, {})[leaf] = arr
        else:
            plain[name] = tensor_from_numpy(arr, device)

    # only a group with the __packed__ marker is a PackedLinear
    for base, parts in list(packed_groups.items()):
        if "__packed__" not in parts:
            for leaf, arr in parts.items():
                plain[f"{base}.{leaf}"] = tensor_from_numpy(arr, device)
            del packed_groups[base]

    for name, t in plain.items():
        _insert(tree, name, t)
    for base, parts in packed_groups.items():
        bits, gs, in_f, out_f = (int(x) for x in parts["__packed__"])
        bias = parts.get("bias")
        _insert(tree, base, PackedLinear(
            codes=tensor_from_numpy(parts["codes"], device),
            scale=tensor_from_numpy(parts["scale"], device),
            zero=tensor_from_numpy(parts["zero"], device),
            bits=bits, group_size=gs, in_features=in_f, out_features=out_f,
            bias=None if bias is None else tensor_from_numpy(bias, device)))


def load_quantized(path: str, layer_callback=None, device: str = "cuda"):
    """Load a packed checkpoint → (params tree with PackedLinear leaves,
    ModelConfig, quant_config dict), tensors on ``device``.

    Layer-sharded checkpoints stream one npz at a time;
    ``layer_callback(li, layer_tree) -> layer_tree`` runs on each layer
    subtree as soon as it is assembled."""
    dev = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        meta = json.load(f)
    cfg = ModelConfig(**meta["model_config"])
    layout = int(meta.get("pack_layout", 1))
    if layout != PACK_LAYOUT_VERSION:
        w_bits = int(meta.get("quant_config", {}).get("w_bits", 0))
        if w_bits == 3 or w_bits == 0:
            raise ValueError(
                f"checkpoint pack_layout v{layout} != current "
                f"v{PACK_LAYOUT_VERSION}: the int3 code layout changed "
                "(triple-byte bit-planes -> planes21).  Re-quantize or "
                "re-pack the checkpoint.  (int4/int2/int8 layouts are "
                "unchanged; checkpoints at those widths load by setting "
                "pack_layout in config.json.)")
    kv_eq: dict[str, np.ndarray] = {}
    tree: dict = {}
    with np.load(os.path.join(path, "weights.npz")) as data:
        _decode_arrays(dict(data), tree, kv_eq, dev)
    n_shards = int(meta.get("layer_shards", 0))
    if n_shards:
        layers = tree.setdefault("model", {}).setdefault("layers", [])
        for li in range(n_shards):
            sub: dict = {}
            with np.load(os.path.join(path, f"layer_{li:03d}.npz")) as data:
                _decode_arrays(dict(data), sub, kv_eq, dev)
            if layer_callback is not None:
                sub = layer_callback(li, sub)
            while len(layers) <= li:
                layers.append(None)
            layers[li] = sub
    qconf = dict(meta.get("quant_config", {}))
    if kv_eq:
        qconf["kv_equalizers"] = (kv_eq["k"], kv_eq["v"])
    return tree, cfg, qconf
