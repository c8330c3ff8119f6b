from tgq_torch.core.quant import (QuantSpec, QuantParams, find_params, expand_params,
                                  quantize, dequantize, fake_quantize)
from tgq_torch.core.packing import pack_rows, unpack_rows, PackedLinear
