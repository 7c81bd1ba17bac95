from .compression import compress_grads, dequantize_int8, quantize_int8

__all__ = ["compress_grads", "dequantize_int8", "quantize_int8"]
