from .collective_matmul import tp_matmul
from .compression import compress_grads, dequantize_int8, quantize_int8
from .sharding import cache_pspecs, input_pspecs, logits_pspec, param_pspecs

__all__ = ["tp_matmul", "compress_grads", "dequantize_int8", "quantize_int8",
           "cache_pspecs", "input_pspecs", "logits_pspec", "param_pspecs"]
