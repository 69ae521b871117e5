"""Step builders of the LM zoo's training (the reference's
``repro.launch``, single device)."""

from .steps import make_optimizer, make_train_fn, named_leaves, value_and_grad

__all__ = ["make_optimizer", "make_train_fn", "named_leaves", "value_and_grad"]
