"""Training of the Molecular Transformer and the decoder-only / audio
architectures: the port of ``repro.training``."""

from repro_torch.training.loss import cross_entropy_loss
from repro_torch.training.optimizer import adam_init, adam_update, noam_schedule
from repro_torch.training.trainer import (Trainer, lm_loss_and_grads,
                                          make_lm_train_step,
                                          make_seq2seq_train_step,
                                          seq2seq_loss_and_grads)

__all__ = ["cross_entropy_loss", "adam_init", "adam_update", "noam_schedule",
           "Trainer", "make_seq2seq_train_step", "seq2seq_loss_and_grads",
           "make_lm_train_step", "lm_loss_and_grads"]
