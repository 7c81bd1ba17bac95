from .model import (cache_spec, decode_step, forward, init_cache,
                    init_model_params, param_specs, prefill_step,
                    prepare_params)

__all__ = ["cache_spec", "decode_step", "forward", "init_cache",
           "init_model_params", "param_specs", "prefill_step",
           "prepare_params"]
