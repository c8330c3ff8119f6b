from tgq_torch.calib.data import get_loaders, load_eval_tokens, synthetic_calibration
from tgq_torch.calib.pipeline import quantize_model, QuantizeConfig
