from tgq_torch.utils.logging import setup_logging
from tgq_torch.utils.precision import exact_f32_matmul, resolve_device
from tgq_torch.utils.profiling import PhaseTimers
