"""Tensor and data parallelism: the ("data", "model") mesh of ranks, the
TP sharding rules, the data-parallel Hessian, process bring-up and the
multi-rank dry run."""
from tgq_torch.parallel.mesh import (
    Mesh,
    dp_hessian_gram,
    local_config,
    make_mesh,
    mark_tp_kinds,
    quantized_matmul_tp,
    serving_mesh_scope,
    set_serving_mesh,
    shard_params,
)

__all__ = ["Mesh", "dp_hessian_gram", "local_config", "make_mesh", "mark_tp_kinds",
           "quantized_matmul_tp", "serving_mesh_scope", "set_serving_mesh", "shard_params"]
