from .model import (cache_spec, decode_step, embed_inputs, forward,
                    init_cache, init_model_params, input_specs, param_shapes,
                    param_specs, prefill_step, prepare_params)

__all__ = ["cache_spec", "decode_step", "embed_inputs", "forward",
           "init_cache", "init_model_params", "input_specs", "param_shapes",
           "param_specs", "prefill_step", "prepare_params"]
