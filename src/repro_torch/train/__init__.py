from .step import loss_fn, make_train_step, train_step

__all__ = ["loss_fn", "make_train_step", "train_step"]
