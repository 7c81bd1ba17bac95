"""The refusal of the kernels that have no backward yet."""
import torch


def refuse_grad(kernel: str, training: str, *tensors: torch.Tensor) -> None:
    """Raise ``NotImplementedError`` when grad mode is on and an operand of
    ``kernel``'s CUDA launch requires grad: its output would carry no
    gradient, and a model would train on zeros.  The plain version on the
    CPU differentiates as it is."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel} has no backward kernel yet: {training} on the card "
            f"comes in a later slice of the port (train on the CPU, or call "
            f"under torch.no_grad())")
