"""Optimizers (counterpart: pssr2_tpu/optim.py:13-25; reference:
pssr/__main__.py:120-123).  The JAX package wraps ``optax.adamw``; here
the step is ``torch.optim.AdamW``, the same update with the same
defaults."""

import torch


class AdamW:
    """AdamW with torch-default hyperparameters
    (lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2).

    ``init(params)`` builds the optimizer over the parameters, as the JAX
    wrapper's ``init`` builds the optax state.  ``torch.optim.AdamW`` skips
    a parameter whose ``grad`` is None, weight decay included, where optax
    decays it: the train step gives every parameter a gradient (zeros where
    autograd gave none), so both move such a parameter alike."""

    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 1e-2):
        self.lr = float(lr)
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay

    def init(self, params):
        return torch.optim.AdamW(
            params, lr=self.lr, betas=self.betas, eps=self.eps, weight_decay=self.weight_decay
        )
