"""The port's training (the torch counterpart of ``repro.train``): the
train step (``make_train_step``: CE + MoE aux + MTP loss, microbatched
gradients, AdamW) and the ``Trainer`` loop."""
from .loop import Trainer, TrainerConfig
from .step import TrainState, cross_entropy, loss_fn, make_train_step

__all__ = ["TrainState", "Trainer", "TrainerConfig", "cross_entropy", "loss_fn",
           "make_train_step"]
