from tgq_torch.models.config import ModelConfig, PRESETS
from tgq_torch.models.causal_lm import (
    init_params,
    embed_tokens,
    decoder_layer,
    apply_final_norm,
    lm_logits,
    forward,
    rope_cache,
    find_linear_paths,
    sequenced_groups,
)
