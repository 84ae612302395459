"""Train and eval steps, and the optimizer factory.

Port of `dnn_based_source_separation_tpu/train/steps.py:18-210`. The
JAX package compiles forward + PIT loss + backward + clip + update into
one XLA program; here the step runs eagerly on the model's device, and the
loss stays a device tensor so a training loop never waits on the card.

The optimizer keeps optax's update rules on `torch.optim`:
- `adam`: optax.adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root),
  which is `torch.optim.Adam`'s arithmetic;
- `sgd` / `momentum-sgd`: optax.sgd, with momentum as optax.trace
  (`t = g + m * t`, the update `lr * t`), which is `torch.optim.SGD`'s;
- global-norm clipping as `optax.clip_by_global_norm`: every gradient is
  scaled by `max_norm / norm` only when `norm >= max_norm`
  (`torch.nn.utils.clip_grad_norm_` scales by `max_norm / (norm + 1e-6)`
  whenever that is below 1, which is another function);
- the learning rate lives in the param groups, so the Trainer's halving
  changes it in place, as `optax.inject_hyperparams` does;
- `rmsprop`: optax.rmsprop's `scale_by_rms` (decay 0.9, `nu` initialised to 0,
  eps 1e-8 inside the square root, no centring, no momentum), `OptaxRMSprop`:
  `torch.optim.RMSprop` puts eps outside the square root, another function;
- `make_warmup_optimizer`: Adam under the DPTNet recipe's warmup schedule
  (`WarmupOptimizer`), which the halving leaves alone, as JAX's does.

`make_attractor_train_step` is the step of the attractor models (DANet), whose
batches carry the oracle assignment and the threshold weight.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch
from torch.func import functional_call

from ..ops.rnn import set_dropout_generator


class Optimizer:
    """A `torch.optim` optimizer with optax's global-norm clipping in front of its step."""

    def __init__(self, inner: torch.optim.Optimizer, max_norm: Optional[float]):
        self.inner, self.max_norm = inner, max_norm
        self.params = [p for group in inner.param_groups for p in group["params"]]

    @property
    def param_groups(self):
        return self.inner.param_groups

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        if self.max_norm is not None:
            clip_by_global_norm_([p.grad for p in self.params if p.grad is not None],
                                 self.max_norm)
        self.inner.step()

    def state_dict(self) -> dict:
        return self.inner.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state)


@torch.no_grad()
def clip_by_global_norm_(grads: list, max_norm: float) -> torch.Tensor:
    """Scale `grads` in place as `optax.clip_by_global_norm(max_norm)` does; return the norm.

    norm = sqrt(sum of every squared element); when norm >= max_norm each
    gradient becomes `g / norm * max_norm`. The choice is made on the
    device (no host synchronisation).
    """
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float())
                                                 for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


class OptaxRMSprop(torch.optim.Optimizer):
    """optax.rmsprop(lr, decay, eps): nu = decay nu + (1 - decay) g^2 from nu = 0, then
    p -= lr g / sqrt(nu + eps)."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad, value=1.0 - group["decay"])
                p.addcdiv_(p.grad, (nu + group["eps"]).sqrt(), value=-group["lr"])


def make_optimizer(name: str, lr: float = 1e-3, max_norm: Optional[float] = None,
                   momentum: float = 0.9, *, params: Iterable[torch.Tensor]) -> Optimizer:
    """'adam' | 'sgd' | 'momentum-sgd' | 'rmsprop' over `params`, with optional global-norm
    clipping.

    Mirrors the JAX `make_optimizer` (the recipe's optimizer choice and
    clip_grad_norm); 'rmsprop' is optax's (`OptaxRMSprop`), as the DANet recipe trains.
    """
    params = [p for p in params if p.requires_grad]
    if name == "adam":
        inner = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    elif name == "sgd":
        inner = torch.optim.SGD(params, lr=lr)
    elif name == "momentum-sgd":
        inner = torch.optim.SGD(params, lr=lr, momentum=momentum)
    elif name == "rmsprop":
        inner = OptaxRMSprop(params, lr=lr)
    else:
        raise ValueError(f"Unsupported optimizer: {name}")
    return Optimizer(inner, max_norm)


class WarmupOptimizer(Optimizer):
    """An `Optimizer` whose learning rate is `schedule(i)` at update i, counting from 0.

    optax evaluates a schedule at its own update count before incrementing
    it (`scale_by_schedule`); the count goes into `state_dict`, so a resumed
    run continues the schedule where it stopped, as optax's state does.
    """

    def __init__(self, inner: torch.optim.Optimizer, max_norm: Optional[float],
                 schedule: Callable[[int], float]):
        super().__init__(inner, max_norm)
        self.schedule, self.count = schedule, 0

    @torch.no_grad()
    def step(self) -> None:
        for group in self.param_groups:
            group["lr"] = self.schedule(self.count)
        super().step()
        self.count += 1

    def state_dict(self) -> dict:
        return {**self.inner.state_dict(), "schedule_count": self.count}

    def load_state_dict(self, state: dict) -> None:
        state = dict(state)
        self.count = int(state.pop("schedule_count"))
        self.inner.load_state_dict(state)


def make_warmup_optimizer(lr_peak_k1: float, lr_post_k2: float, d_model: int,
                          warmup_steps: int, steps_per_epoch: int,
                          max_norm: Optional[float] = None, *,
                          params: Iterable[torch.Tensor]) -> WarmupOptimizer:
    """Adam with the DPTNet recipe's learning-rate schedule (JAX `train/steps.py:67-90`).

    Update i (from 0) uses `k1 * d_model^-0.5 * (i + 1) * warmup^-1.5` (a linear ramp)
    while i <= warmup_steps, then `k2 * 0.98^floor((epoch + 1) / 2)` with epoch = i //
    steps_per_epoch; the comparison is strict, as `jnp.where(step > warmup, ...)`.
    Clipping by global norm comes first when `max_norm` is given (optax's chain order).
    The Trainer's learning-rate halving leaves it alone (`set_learning_rate`).
    """

    def schedule(i: int) -> float:
        if i > warmup_steps:
            return lr_post_k2 * 0.98 ** ((i // steps_per_epoch + 1) // 2)
        return lr_peak_k1 * d_model ** -0.5 * (i + 1) * warmup_steps ** -1.5

    params = [p for p in params if p.requires_grad]
    inner = torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8)
    return WarmupOptimizer(inner, max_norm, schedule)


def get_learning_rate(optimizer: Optimizer) -> float:
    """The learning rate; NaN for a scheduled optimizer, as JAX's `get_learning_rate`."""
    if isinstance(optimizer, WarmupOptimizer):
        return float("nan")
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: Optimizer, lr: float) -> Optimizer:
    """Set the learning rate; a scheduled optimizer is left alone: its schedule owns it."""
    if isinstance(optimizer, WarmupOptimizer):
        return optimizer
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer


def _loss_of(out) -> torch.Tensor:
    """Criteria follow the PIT protocol, (loss, pattern); plain scalar criteria work too."""
    return out[0] if isinstance(out, tuple) else out


def make_train_step(model: torch.nn.Module, criterion: Callable, optimizer: Optimizer,
                    compute_dtype: Optional[torch.dtype] = None,
                    generator: Optional[torch.Generator] = None) -> Callable:
    """Build (mixture, sources, *extra) -> loss: forward, PIT loss in f32, backward, clip,
    update; the batch's `extra` fields go to the criterion after the sources (ORPIT's
    counts: `criterion(estimates, sources, counts)`).

    The loss comes back as a detached device tensor; nothing synchronises.
    compute_dtype=torch.bfloat16 is the JAX package's mixed precision
    (`steps.py:113-115, 139-161`): the f32 master parameters and buffers are
    cast to bfloat16 inside the step and the model runs on those copies
    (`torch.func.functional_call`), the mixture is cast too, and the
    estimates go back to f32 before the loss. Gradients flow through the
    casts onto the f32 parameters, where the optimizer and its state stay;
    the buffers the forward updated in place on the copies (BatchNorm's
    running statistics) are written back to the f32 buffers, as JAX writes
    `new_aux` back. It is not `torch.autocast`, which keeps some ops in f32
    and so computes another function.

    `generator`, if given (a `torch.Generator` on the model's device), draws
    the dropout masks of the model's LSTMs and GRUs, one draw after another
    across steps: the counterpart of the JAX step's `dropout_rng`, split
    once a step (`with_dropout_rng`, steps.py:163-167).
    """
    if generator is not None:
        set_dropout_generator(model, generator)

    def cast(tensors: dict) -> dict:
        return {k: v.to(compute_dtype) if v.dtype == torch.float32 else v
                for k, v in tensors.items()}

    def step(mixture: torch.Tensor, sources: torch.Tensor, *extra) -> torch.Tensor:
        model.train()
        optimizer.zero_grad()
        if compute_dtype is None:
            estimates = model(mixture)
        else:
            buffers = dict(model.named_buffers())
            state = cast({**dict(model.named_parameters()), **buffers})
            versions = {name: state[name]._version for name in buffers}
            estimates = functional_call(model, state, (mixture.to(compute_dtype),)).float()
            with torch.no_grad():  # only what the forward wrote: a window stays f32
                for name, buf in buffers.items():
                    if state[name] is not buf and state[name]._version != versions[name]:
                        buf.copy_(state[name])
        loss = _loss_of(criterion(estimates, sources, *extra))
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_attractor_train_step(model: torch.nn.Module, criterion: Callable,
                              optimizer: Optimizer) -> Callable:
    """Build (mixture, sources, assignment, threshold_weight) -> loss for DANet (JAX
    `train/steps.py:213`): the oracle attractors from the batch's assignment, the loss
    `criterion(model(mixture, assignment, threshold_weight), sources)`.

    The JAX step applies the model with `train=False`, so DANet's dropout never acts
    there; the model runs in eval mode here for the same function.
    """

    def step(mixture, sources, assignment, threshold_weight) -> torch.Tensor:
        model.eval()
        optimizer.zero_grad()
        loss = _loss_of(criterion(model(mixture, assignment, threshold_weight), sources))
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_eval_step(model: torch.nn.Module, criterion: Callable) -> Callable:
    """Build (mixture, sources, *extra) -> (loss, estimates), under `torch.no_grad()`; the
    `extra` fields go to the criterion as in `make_train_step`."""

    @torch.no_grad()
    def step(mixture: torch.Tensor, sources: torch.Tensor, *extra):
        model.eval()
        estimates = model(mixture)
        return _loss_of(criterion(estimates, sources, *extra)), estimates

    return step
