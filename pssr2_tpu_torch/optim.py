"""Optimizers and schedulers with torch-like stateful semantics
(counterpart: pssr2_tpu/optim.py:13-84; reference: pssr/__main__.py:120-123,
pssr/train.py:77,160-164).  The JAX package wraps ``optax.adamw`` and
``optax.sgd``; here the steps are ``torch.optim.AdamW`` and
``torch.optim.SGD``, the same updates with the same defaults.  The
schedulers change the wrapper's host-side ``lr``, which the train step
writes into the optimizer before each step, as the JAX package feeds it
to its jitted step.  ``lr_finder`` is not ported yet."""

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


class SGD:
    """SGD with optional momentum (``optax.sgd`` parity: the trace ``v = g +
    momentum v``, then ``p -= lr v``, which is ``torch.optim.SGD`` with no
    dampening)."""

    def __init__(self, lr: float = 1e-3, momentum: float = 0.0):
        self.lr = float(lr)
        self.momentum = momentum

    def init(self, params):
        return torch.optim.SGD(params, lr=self.lr, momentum=self.momentum)


class ExponentialLR:
    """Multiply lr by gamma each epoch (torch ExponentialLR parity)."""

    def __init__(self, optim, gamma: float, verbose: bool = False):
        self.optim = optim
        self.gamma = gamma
        self.verbose = verbose

    def step(self):
        self.optim.lr *= self.gamma
        if self.verbose:
            print(f"Adjusting learning rate to {self.optim.lr:.4e}.")


class ReduceLROnPlateau:
    """Reduce lr when a metric stops improving (torch parity: mode='min',
    factor, patience, threshold as relative improvement)."""

    def __init__(self, optim, mode: str = "min", factor: float = 0.1, patience: int = 10, threshold: float = 1e-4,
                 min_lr: float = 0.0, verbose: bool = False):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.optim = optim
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.verbose = verbose
        self.best = None
        self.num_bad = 0

    def _is_better(self, metric):
        if self.best is None:
            return True
        if self.mode == "min":
            return metric < self.best * (1 - self.threshold)
        return metric > self.best * (1 + self.threshold)

    def step(self, metric):
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.optim.lr = max(self.optim.lr * self.factor, self.min_lr)
            self.num_bad = 0
            if self.verbose:
                print(f"Reducing learning rate to {self.optim.lr:.4e}.")
