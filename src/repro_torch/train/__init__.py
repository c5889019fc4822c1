"""Training for the dense and MoE families (port of ``repro.train``): optimizers over
the reference's parameter trees and the step factories."""
from .optimizer import (AdafactorState, Adafactor, AdamW, AdamWState,
                        cosine_schedule, get_optimizer)
from .step import (default_lr, default_optimizer, make_decode_step,
                   make_loss, make_prefill_step, make_train_step)

__all__ = ["AdamW", "AdamWState", "Adafactor", "AdafactorState",
           "cosine_schedule", "get_optimizer", "default_lr",
           "default_optimizer", "make_decode_step", "make_loss",
           "make_prefill_step", "make_train_step"]
