"""Tensor ops of the port: masked matmul, attention, calibration
statistics, mask selection and quantization (counterparts of
``vlm_compression_tpu.ops``).  Kernel modules expose a plain ``launches``
counter each.  The package exports the JAX package's quantization and GPTQ
names; AWQ is imported from ``ops.awq``."""

from vlm_compression_tpu_torch.ops.quant import (  # noqa: F401
    dequantize_params_tree,
    int8_matmul,
    int8_matmul_dynamic,
    int8_matmul_outlier,
    quantize_params_tree,
    quantize_weight,
    set_int8_outliers,
    use_dynamic_int8,
)
from vlm_compression_tpu_torch.ops.gptq import (  # noqa: F401
    GPTQResult,
    gptq_dequantize,
    gptq_quantize,
    gptq_to_int4_params,
    gptq_quantize_batched,
    rtn_quantize,
)
