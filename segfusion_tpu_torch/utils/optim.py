"""Optimizers with the optax semantics the JAX package trains with.

Port of ``segfusion_tpu/utils/optim.py`` plus the global-norm clipping
that its trainer chains in front (``optax.clip_by_global_norm(1.0)``):
:class:`Optimizer` clips the summed gradients, adds weight decay to them
(optax ``add_decayed_weights``, as torch's ``weight_decay`` does) and
applies the named rule with the learning rate ``schedule(count)``,
``count`` being the number of updates made so far.

Where ``torch.optim`` computes optax's update it is used: ``sgd`` (and
``asgd``, plain SGD in the JAX package), ``adam``, ``adamax`` and
``adadelta``. Two rules differ and are written here over the parameter
tensors:

- ``rmsprop``: optax puts eps inside the root (``g * rsqrt(nu + eps)``)
  and applies momentum as a trace of the already lr-scaled update, which
  under a changing rate is not torch's ``lr * buf``;
- ``adagrad``: optax starts the accumulator at 0.1 and also puts eps
  inside the root.

:meth:`Optimizer.state_dict_flax` writes the state in the layout
``flax.serialization.to_state_dict`` gives the optax state (chain
elements ``"0"``, ``"1"``, ... with optax's field names and per-parameter
trees in Flax layout), so checkpoints carry it across both packages.

:class:`MultiSteps` is ``optax.MultiSteps(tx, every_k_schedule=k)`` over
an :class:`Optimizer` (the clipping and the rule chained first, then
wrapped), as the JAX trainer accumulates per-frame steps: it keeps the
running mean of k mini-step gradients and applies the wrapped update to
that mean at every k-th step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from .convert import flax_tree, from_flax_tree

__all__ = ["Optimizer", "MultiSteps", "get_optimizer",
           "clip_by_global_norm_"]


class RMSprop(torch.optim.Optimizer):
    """optax ``rmsprop`` (not centered, no bias correction): nu = (1 -
    decay) g^2 + decay nu; u = -lr g rsqrt(nu + eps); with momentum, trace
    t = u + momentum t and u = t; p += u."""

    def __init__(self, params, lr, decay=0.9, eps=1e-8, momentum=0.0,
                 weight_decay=0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      momentum=momentum,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            decay, m = group["decay"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                st = self.state[p]
                if "nu" not in st:
                    st["nu"] = torch.zeros_like(p)
                    if m:
                        st["trace"] = torch.zeros_like(p)
                nu = st["nu"]
                nu.copy_((1 - decay) * g.square() + decay * nu)
                u = -group["lr"] * (g * torch.rsqrt(nu + group["eps"]))
                if m:
                    u = st["trace"].copy_(u + m * st["trace"])
                p.add_(u)


class Adagrad(torch.optim.Optimizer):
    """optax ``adagrad``: s = g^2 + s (s starts at 0.1); u = -lr g
    rsqrt(s + eps) where s > 0, else 0; p += u."""

    def __init__(self, params, lr, eps=1e-7, initial_accumulator_value=0.1,
                 weight_decay=0.0):
        super().__init__(params, dict(
            lr=lr, eps=eps, weight_decay=weight_decay,
            initial_accumulator_value=initial_accumulator_value))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                st = self.state[p]
                if "sum_of_squares" not in st:
                    st["sum_of_squares"] = torch.full_like(
                        p, group["initial_accumulator_value"])
                s = st["sum_of_squares"]
                s.copy_(g.square() + s)
                scale = torch.where(s > 0, torch.rsqrt(s + group["eps"]),
                                    0.0)
                p.add_(-group["lr"] * (scale * g))


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` on the ``.grad`` of ``params``, in
    place: where the global norm n >= max_norm each gradient becomes
    (g / n) * max_norm. Returns n."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    if norm >= max_norm:
        for g in grads:
            g.copy_((g / norm) * max_norm)
    return norm


# name -> (chain of optax state elements, optax field -> torch state key)
# for the rule after the weight decay; () is an EmptyState, "count" an
# int32 scalar, any other field a per-parameter tree
def _layout(name: str, momentum: float):
    trace = ("trace",) if momentum else ()
    if name in ("sgd", "asgd"):
        return [trace, ("count",)], {"trace": "momentum_buffer"}
    if name == "adam":
        return [("count", "mu", "nu"), ("count",)], {
            "count": "step", "mu": "exp_avg", "nu": "exp_avg_sq"}
    if name == "adamax":
        return [("count", "mu", "nu"), ("count",)], {
            "count": "step", "mu": "exp_avg", "nu": "exp_inf"}
    if name == "adadelta":
        return [(), ("e_g", "e_x"), ("count",)], {
            "e_g": "square_avg", "e_x": "acc_delta"}
    if name == "adagrad":
        return [("sum_of_squares",), ("count",)], {
            "sum_of_squares": "sum_of_squares"}
    if name == "rmsprop":
        return [("nu",), ("count",), trace], {"nu": "nu", "trace": "trace"}
    raise NotImplementedError(f"Optimizer {name} not implemented")


class Optimizer:
    """One optax-equivalent update per :meth:`step` over the ``.grad``
    of ``module``'s parameters (summed by the caller's backward passes):
    clip (optional), weight decay, the named rule at lr =
    ``schedule(count)``."""

    def __init__(self, module: torch.nn.Module, name: str,
                 hparams: Dict[str, float], schedule: Callable[[int], float],
                 clipping: bool = False):
        self.module = module
        self.name = name
        self.schedule = schedule
        self.clipping = clipping
        self.count = 0
        self.named = [(n, p) for n, p in module.named_parameters()]
        params = [p for _, p in self.named]
        wd = hparams["weight_decay"]
        lr0 = schedule(0)
        m = hparams["momentum"]
        self.weight_decay = wd
        if name in ("sgd", "asgd"):
            self.opt = torch.optim.SGD(params, lr=lr0, momentum=m,
                                       weight_decay=wd)
        elif name == "adam":
            self.opt = torch.optim.Adam(params, lr=lr0,
                                        betas=hparams["betas"],
                                        eps=hparams["eps"], weight_decay=wd)
        elif name == "adamax":
            self.opt = torch.optim.Adamax(params, lr=lr0, eps=hparams["eps"],
                                          weight_decay=wd)
        elif name == "adadelta":
            self.opt = torch.optim.Adadelta(params, lr=lr0,
                                            rho=hparams["rho"],
                                            eps=hparams["eps"],
                                            weight_decay=wd)
        elif name == "adagrad":
            self.opt = Adagrad(params, lr=lr0, eps=hparams["eps"],
                               weight_decay=wd)
        elif name == "rmsprop":
            self.opt = RMSprop(params, lr=lr0, decay=hparams["alpha"],
                               eps=hparams["eps"], momentum=m,
                               weight_decay=wd)
        else:
            raise NotImplementedError(f"Optimizer {name} not implemented")
        self.chain, self.keys = _layout(name, m)

    def zero_grad(self):
        for _, p in self.named:
            p.grad = None

    def lr(self) -> float:
        """The rate of the next update."""
        return float(self.schedule(self.count))

    def step(self):
        """Clip, then update at the scheduled rate; count += 1."""
        if self.clipping:
            clip_by_global_norm_([p for _, p in self.named], 1.0)
        for group in self.opt.param_groups:
            group["lr"] = self.lr()
        self.opt.step()
        self.count += 1

    # -- optax-layout state -------------------------------------------------

    def _field(self, field: str) -> dict:
        key = self.keys[field]
        init = (self.opt.defaults.get("initial_accumulator_value", 0.0)
                if field == "sum_of_squares" else 0.0)
        values = {}
        for n, p in self.named:
            st = self.opt.state.get(p, {})
            values[n] = st[key] if key in st else torch.full_like(p, init)
        return flax_tree(self.module, values)

    def _wrap(self, rule: dict) -> dict:
        """The rule's state inside the weight-decay and clipping chains."""
        if self.weight_decay:
            rule = {"0": {}, "1": rule}
        if self.clipping:
            rule = {"0": {}, "1": rule}
        return rule

    def state_dict_flax(self) -> dict:
        """The optax state of the chain this optimizer computes, as
        ``flax.serialization.to_state_dict`` lays it out (numpy leaves)."""
        count = np.asarray(self.count, np.int32)
        rule = {str(i): {f: (count if f == "count" else self._field(f))
                         for f in fields}
                for i, fields in enumerate(self.chain)}
        return self._wrap(rule)

    def load_state_dict_flax(self, state: dict):
        """Restore from :meth:`state_dict_flax`'s layout (as either
        package writes it)."""
        if self.clipping:
            state = state["1"]
        if self.weight_decay:
            state = state["1"]
        count = None
        for i, fields in enumerate(self.chain):
            elem = state[str(i)]
            for f in fields:
                if f == "count":
                    count = int(np.asarray(elem[f]))
                    continue
                values = from_flax_tree(self.module, elem[f])
                for n, p in self.named:
                    self.opt.state[p][self.keys[f]] = torch.as_tensor(
                        values[n], dtype=p.dtype, device=p.device).clone()
        self.count = count
        if self.name in ("adam", "adamax", "adadelta"):
            for _, p in self.named:   # torch's own step counter
                self.opt.state[p]["step"] = torch.tensor(float(count))


class MultiSteps:
    """optax ``MultiSteps(inner, every_k_schedule=k)`` with the gradient
    mean: each :meth:`step` folds the ``.grad`` of the inner optimizer's
    parameters into the running mean ``acc + (g - acc) / (n + 1)`` of
    this cycle's n earlier mini-steps; the k-th step of a cycle hands
    that mean to the inner optimizer (clipping, weight decay, the rule,
    its count) and restarts the cycle. The other steps change neither the
    parameters nor the inner optimizer."""

    def __init__(self, inner: Optimizer, every_k: int):
        self.inner = inner
        self.k = int(every_k)
        self.mini_step = 0
        self.gradient_step = 0
        self.acc = {n: torch.zeros_like(p) for n, p in inner.named}

    def zero_grad(self):
        self.inner.zero_grad()

    @torch.no_grad()
    def step(self):
        n = self.mini_step
        for name, p in self.inner.named:
            if p.grad is not None:
                acc = self.acc[name]
                acc.copy_(acc + (p.grad - acc) / (n + 1))
        if n < self.k - 1:
            self.mini_step += 1
            return
        for name, p in self.inner.named:
            p.grad = self.acc[name].clone()
        self.inner.step()
        for acc in self.acc.values():
            acc.zero_()
        self.mini_step = 0
        self.gradient_step += 1

    def state_dict_flax(self) -> dict:
        """``optax.MultiStepsState`` as ``flax.serialization`` lays it out."""
        return {"mini_step": np.asarray(self.mini_step, np.int32),
                "gradient_step": np.asarray(self.gradient_step, np.int32),
                "inner_opt_state": self.inner.state_dict_flax(),
                "acc_grads": flax_tree(self.inner.module, self.acc),
                "skip_state": {}}

    def load_state_dict_flax(self, state: dict):
        self.mini_step = int(np.asarray(state["mini_step"]))
        self.gradient_step = int(np.asarray(state["gradient_step"]))
        self.inner.load_state_dict_flax(state["inner_opt_state"])
        values = from_flax_tree(self.inner.module, state["acc_grads"])
        for n, p in self.inner.named:
            self.acc[n].copy_(torch.as_tensor(np.array(values[n]),
                                              dtype=p.dtype))


def _hparams(opt_cfg) -> Tuple[str, Dict[str, Any]]:
    name = opt_cfg.get("name", "sgd")
    betas = opt_cfg.get("betas", (0.9, 0.999))
    return name, {
        "weight_decay": float(opt_cfg.get("weight_decay", 0.0) or 0.0),
        "momentum": float(opt_cfg.get("momentum", 0.0) or 0.0),
        "eps": float(opt_cfg.get("eps", 1e-8) or 1e-8),
        "betas": (float(betas[0]), float(betas[1])),
        "rho": float(opt_cfg.get("rho", 0.9)),
        "alpha": float(opt_cfg.get("alpha", 0.99)),
    }


def get_optimizer(opt_cfg, module: torch.nn.Module,
                  schedule: Callable[[int], float],
                  clipping: bool = False) -> Optimizer:
    """TRAINING.optimizer config -> :class:`Optimizer` over ``module``'s
    parameters, the rate from ``schedule`` (the JAX package's factory, its
    7 names; ``asgd`` is plain SGD there)."""
    name, hp = _hparams(opt_cfg)
    if name == "asgd":
        hp["momentum"] = 0.0
    return Optimizer(module, name, hp, schedule, clipping)
