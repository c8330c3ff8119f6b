from tgq_torch.solver.hessian import (HessianAccumulator, SketchAccumulator,
                                     hessian_from_activations)
from tgq_torch.solver.factorize import (
    FactorResult,
    trunc_spectral_factor,
    gptq_cholesky_factor,
    sketch_factor,
    truncate_rank,
)
from tgq_torch.solver.gptq_loop import quantize_weight, QuantizeResult
from tgq_torch.solver.pqr import pivoted_qr
