"""Parameter-averaging optimizer wrappers, the port of
`paddle_tpu/optimizer/averaging.py` (:33-302):

- `ExponentialMovingAverage`: shadow_t = d_t * shadow_{t-1} + (1 - d_t)
  * theta_t in f32, bias-corrected at `apply()` by 1 - prod(d_t), the
  product of the decays actually applied (`thres_steps` schedules d_t =
  min(decay, (1 + t) / (10 + t))), not 1 - decay ** t;
- `LookAhead`: the inner optimizer steps the fast weights every call;
  every k calls slow += alpha * (fast - slow) and fast = slow;
- `ModelAverage`: a running f32 sum of the parameters and a count;
  `apply()` swaps in the window average, the window restarting under
  the reference's condition (one running sum in place of the
  reference's three tiers, as in the JAX package).

They are state machines around the train step, as in the JAX package,
where `jnp` computes them outside any kernel: here plain torch ops on
the parameters' device, under `torch.no_grad()` (`torch._foreach_*`
for the per-parameter loops). `apply()` copies the averaged values into
the parameters in place (their tensors keep their identity, so a
model, an optimizer or a train step that holds them sees the swap) and
`restore()` copies the saved values back, bit for bit. Each class has
`state_dict` / `set_state_dict`.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["ExponentialMovingAverage", "LookAhead", "ModelAverage"]


def _params_of(parameters):
    """Parameter tensors of an iterable of tensors or (name, tensor)
    pairs."""
    return [p[1] if isinstance(p, tuple) else p for p in (parameters or ())]


class _Swap:
    """`apply()` / `restore()`: the parameters' values saved, replaced,
    and put back in place."""

    def __init__(self):
        self._backup = None

    @torch.no_grad()
    def _swap_in(self, params, values):
        self._backup = [p.detach().clone() for p in params]
        for p, v in zip(params, values):
            p.copy_(v)

    @torch.no_grad()
    def _swap_out(self, params):
        if self._backup is None:
            return
        for p, b in zip(params, self._backup):
            p.copy_(b)
        self._backup = None


class ExponentialMovingAverage(_Swap):
    """usage:
        ema = ExponentialMovingAverage(model.parameters(), decay=0.999)
        ... after each optimizer step:  ema.update()
        ... at eval:  with ema.apply(): evaluate(model)
    """

    def __init__(self, parameters=None, decay=0.999, thres_steps=None,
                 name=None):
        super().__init__()
        self._params = _params_of(parameters)
        self._decay = float(decay)
        self._thres_steps = thres_steps
        self._t = 0
        # product of the decays actually applied: the bias correction
        self._corr_prod = 1.0
        self._shadow = [torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device) for p in self._params]

    def _decay_t(self):
        if self._thres_steps is not None:
            ts = float(self._thres_steps() if callable(self._thres_steps)
                       else self._thres_steps)
            return min(self._decay, (1.0 + ts) / (10.0 + ts))
        return self._decay

    @torch.no_grad()
    def update(self):
        """Fold the current parameter values into the shadow EMAs."""
        d = self._decay_t()
        self._t += 1
        self._corr_prod *= d
        if not self._params:
            return
        torch._foreach_mul_(self._shadow, d)
        torch._foreach_add_(self._shadow, [p.float() for p in self._params],
                            alpha=1.0 - d)

    def _corrected(self):
        corr = 1.0 - self._corr_prod
        if corr <= 0.0:  # apply() before any update(): nothing folded
            corr = 1.0 - self._decay ** max(self._t, 1)
        # a true division by the f32 correction, as jnp divides
        return [(s / torch.tensor(corr, dtype=torch.float32,
                                  device=s.device)).to(p.dtype)
                for s, p in zip(self._shadow, self._params)]

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        """Swap the bias-corrected EMAs into the parameters."""
        self._swap_in(self._params, self._corrected())
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    def restore(self, executor=None):
        self._swap_out(self._params)

    def state_dict(self):
        return {"t": self._t, "decay": self._decay,
                "corr_prod": self._corr_prod,
                "shadow": [s.clone() for s in self._shadow]}

    @torch.no_grad()
    def set_state_dict(self, state):
        self._t = int(state["t"])
        self._decay = float(state["decay"])
        # older checkpoints lack corr_prod: decay ** t is exact for them
        # when decay was constant
        self._corr_prod = float(state.get("corr_prod",
                                          self._decay ** self._t))
        for s, v in zip(self._shadow, state["shadow"]):
            s.copy_(torch.as_tensor(v, dtype=torch.float32))


class _InnerWrapper:
    """Shared delegation for optimizer wrappers."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        if name == "_inner":  # copies made without __init__
            raise AttributeError(name)
        return getattr(self._inner, name)

    @property
    def inner_optimizer(self):
        return self._inner

    def clear_grad(self, *a, **kw):
        self._inner.clear_grad(*a, **kw)

    def minimize(self, loss, *a, **kw):
        loss.backward()
        self.step()
        return None, None


class LookAhead(_InnerWrapper):
    """Fast weights step every call; slow weights interpolate every k
    steps: slow += alpha * (fast - slow); fast = slow."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha must be in [0, 1], got {alpha}")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        super().__init__(inner_optimizer)
        self.alpha = float(alpha)
        self.k = int(k)
        self._la_step = 0
        self._slow = None

    def _params(self):
        return [p for _, p in self._inner._named]

    @torch.no_grad()
    def step(self):
        params = self._params()
        if self._slow is None:
            self._slow = [p.detach().to(torch.float32, copy=True)
                          for p in params]
        self._inner.step()
        self._la_step += 1
        if self._la_step % self.k == 0:
            diff = torch._foreach_sub([p.float() for p in params],
                                      self._slow)
            torch._foreach_add_(self._slow, diff, alpha=self.alpha)
            for p, s in zip(params, self._slow):
                p.copy_(s)

    def state_dict(self):
        sd = self._inner.state_dict()
        sd["@lookahead"] = {
            "la_step": self._la_step, "alpha": self.alpha, "k": self.k,
            "slow": ([s.clone() for s in self._slow]
                     if self._slow is not None else None)}
        return sd

    def set_state_dict(self, state):
        state = dict(state)
        la = state.pop("@lookahead", None)
        self._inner.set_state_dict(state)
        if la:
            self._la_step = int(la["la_step"])
            self.alpha = float(la["alpha"])
            self.k = int(la["k"])
            if la["slow"] is not None:
                self._slow = [torch.as_tensor(s, dtype=torch.float32).to(
                    p.device, copy=True)
                    for p, s in zip(self._params(), la["slow"])]


class ModelAverage(_InnerWrapper, _Swap):
    """Accumulate parameter sums each step; `apply()` swaps the window
    average in. Works standalone (`accumulate()` after your own step)
    or around an inner optimizer (`step()`)."""

    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 inner_optimizer=None, name=None):
        _InnerWrapper.__init__(self, inner_optimizer)
        _Swap.__init__(self)
        self.average_window = float(average_window_rate)
        self.min_average_window = int(min_average_window)
        self.max_average_window = int(max_average_window)
        self._params = _params_of(
            parameters if parameters is not None
            else (inner_optimizer._named if inner_optimizer is not None
                  else ()))
        self._sum = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in self._params]
        self._num_accumulates = 0
        self._num_updates = 0

    def __getattr__(self, name):
        if name == "_inner" or self.__dict__.get("_inner") is None:
            raise AttributeError(name)
        return getattr(self._inner, name)

    def step(self):
        if self._inner is None:
            raise RuntimeError("ModelAverage.step() needs an "
                               "inner_optimizer; otherwise call "
                               "accumulate() after your own step")
        self._inner.step()
        self.accumulate()

    @torch.no_grad()
    def accumulate(self):
        self._num_updates += 1
        self._num_accumulates += 1
        p32 = [p.float() for p in self._params]
        if p32:
            torch._foreach_add_(self._sum, p32)
        # window restart (reference conditional, modelaverage.py:49)
        limit = min(self.max_average_window,
                    int(self._num_updates * self.average_window) or 1)
        if (self._num_accumulates >= self.min_average_window
                and self._num_accumulates >= limit):
            # the running sum restarts from the current parameters
            self._num_accumulates = 1
            for s, p in zip(self._sum, p32):
                s.copy_(p)

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        n = torch.tensor(float(max(self._num_accumulates, 1)))
        self._swap_in(self._params, [(s / n.to(s.device)).to(p.dtype)
                                     for s, p in zip(self._sum,
                                                     self._params)])
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    def restore(self, executor=None):
        self._swap_out(self._params)

    def state_dict(self):
        sd = self._inner.state_dict() if self._inner is not None else {}
        sd["@model_average"] = {
            "num_accumulates": self._num_accumulates,
            "num_updates": self._num_updates,
            "sum": [s.clone() for s in self._sum]}
        return sd

    @torch.no_grad()
    def set_state_dict(self, state):
        state = dict(state)
        ma = state.pop("@model_average", None)
        if self._inner is not None and state:
            self._inner.set_state_dict(state)
        if ma:
            self._num_accumulates = int(ma["num_accumulates"])
            self._num_updates = int(ma["num_updates"])
            for s, v in zip(self._sum, ma["sum"]):
                s.copy_(torch.as_tensor(v, dtype=torch.float32))
