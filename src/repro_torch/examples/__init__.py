"""The port's counterparts of the JAX package's ``examples/`` scripts, run
as modules (``python -m repro_torch.examples.<name>``)."""
