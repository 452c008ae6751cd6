"""Batched L-BFGS with a zoom linesearch: the port's copy of optax's
`lbfgs()` at its defaults (optax 0.2.6: `scale_by_lbfgs(memory_size=10,
scale_init_precond=True)`, `scale(-1)`, `scale_by_zoom_linesearch(
max_linesearch_steps=20, initial_guess_strategy='one')`), driven as the JAX
package's `_lbfgs_minimize` drives it (text2protein_tpu/realize/minimize.py):
a fixed number of iterations, the best-so-far iterate, the value and
gradient the linesearch accepted reused by the next iteration
(`optax.value_and_grad_from_state`).

The solver is batched over a leading dim: each element (a restart of a
design) has its own memory, linesearch and best-so-far value, and follows
the trajectory it would follow alone. Under `jax.vmap` the linesearch's
`while_loop` runs until every element is done and holds the finished ones;
here the loop runs while any element is active, evaluates every element
and keeps the results of the active ones only.

Vectors (iterates, gradients, the memory) stay on the parameters' device.
The linesearch's per-element scalars (values, slopes, step sizes, the
bracket) live on the host as float32 numpy arrays, so that its branches
cost no device launches: each linesearch step moves one (2, B) array of
values and slopes to the host, which the loop's condition needs anyway.
"""

from __future__ import annotations

import numpy as np
import torch

# optax.scale_by_zoom_linesearch defaults
MAX_LINESEARCH_STEPS = 20
INCREASE_FACTOR = 2.0
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INTERVAL_THRESHOLD = 1e-5
MEMORY_SIZE = 10

_F = np.float32


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (NaN where it has none)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    r0 = fb - fa - C * db
    r1 = fc - fa - C * dc
    A = (dc * dc * r0 + (-(db * db)) * r1) / denom
    B = ((-(dc * dc * dc)) * r0 + db * db * db * r1) / denom
    radical = B * B - _F(3.0) * A * C
    return a + (-B + np.sqrt(radical)) / (_F(3.0) * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (_F(2.0) * B)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    """Armijo's sufficient decrease, or Hager and Zhang's approximate one
    near a minimum; > 0 where violated, inf where NaN."""
    dec = value - value_init - _F(SLOPE_RTOL) * stepsize * slope_init
    approx = slope - _F(2 * SLOPE_RTOL - 1.0) * slope_init
    delta = value - value_init - _F(APPROX_DEC_RTOL) * np.abs(value_init)
    dec = np.minimum(np.maximum(approx, delta), dec)
    dec = np.maximum(dec, _F(0.0))
    return np.where(np.isnan(dec), _F(np.inf), dec)


def _curvature_error(slope, slope_init):
    err = np.maximum(np.abs(slope) - _F(CURV_RTOL) * np.abs(slope_init),
                     _F(0.0))
    return np.where(np.isnan(err), _F(np.inf), err)


def _where(mask, a, b):
    return np.where(mask, a, b).astype(_F)


class LBFGS:
    """The solver's state for a batch of B problems.

    `energy_fn` maps parameters of shape (B, *shape) to (B,) energies, each
    element's energy depending on that element's parameters only. `step()`
    makes one iteration: the value and gradient at x, the best-so-far
    update, the L-BFGS direction, the linesearch and the step.
    """

    def __init__(self, energy_fn, x0, memory_size: int = MEMORY_SIZE):
        self.fn = energy_fn
        self.shape = x0.shape
        B = x0.shape[0]
        self.x = x0.detach().reshape(B, -1).clone()
        n = self.x.shape[1]
        dev, dt = self.x.device, self.x.dtype
        self.m = memory_size
        self.count = 0
        self.prev_x = torch.zeros_like(self.x)
        self.prev_g = torch.zeros_like(self.x)
        self.mem_dx = torch.zeros((memory_size, B, n), device=dev, dtype=dt)
        self.mem_dg = torch.zeros((memory_size, B, n), device=dev, dtype=dt)
        self.rho = torch.zeros((memory_size, B), device=dev, dtype=dt)
        # the value and gradient at x (the linesearch's last accepted ones)
        self.value = np.full(B, np.inf, _F)
        self.grad = torch.zeros_like(self.x)
        self.x_best = self.x.clone()
        self.f_best = np.full(B, np.inf, _F)
        self.evaluations = 0  # batched value-and-gradient calls
        self.linesearch_steps = []  # per iteration, (B,) steps taken

    def value_and_grad(self, x):
        """(B,) energies and (B, n) gradients at flat parameters x."""
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            e = self.fn(x.view(self.shape))
            (g,) = torch.autograd.grad(e.sum(), x)
        self.evaluations += 1
        return e.detach(), g

    def _mask(self, a):
        return torch.from_numpy(np.asarray(a, bool)).to(self.x.device)

    def _direction(self, g):
        """optax's scale_by_lbfgs then scale(-1): the memory takes the last
        step's differences, then the two-loop recursion gives -P g."""
        m, k = self.m, self.count
        prev = (k - 1) % m
        if k > 0:
            dx = self.x - self.prev_x
            dg = g - self.prev_g
            vdot = torch.sum(dg * dx, -1)
            self.mem_dx[prev] = dx
            self.mem_dg[prev] = dg
            self.rho[prev] = torch.where(vdot == 0.0, 0.0, 1.0 / vdot)
            den = torch.sum(dg * dg, -1)
            scale = torch.where(den > 0.0, vdot / den, 1.0)
        else:
            # the first step: a capped reciprocal of the gradient's norm
            scale = torch.clamp(1.0 / torch.linalg.vector_norm(g, dim=-1),
                                max=1.0)
            self.mem_dx[prev] = 0.0
            self.mem_dg[prev] = 0.0
            self.rho[prev] = 0.0
        order = [(k + i) % m for i in range(m)]
        vec, alphas = g, {}
        for i in reversed(order):
            alphas[i] = self.rho[i] * torch.sum(self.mem_dx[i] * vec, -1)
            vec = vec + (-alphas[i])[:, None] * self.mem_dg[i]
        vec = scale[:, None] * vec
        for i in order:
            beta = self.rho[i] * torch.sum(self.mem_dg[i] * vec, -1)
            vec = vec + (alphas[i] - beta)[:, None] * self.mem_dx[i]
        self.prev_x, self.prev_g = self.x, g
        self.count += 1
        return -1.0 * vec

    def step(self):
        B = self.x.shape[0]
        # optax.value_and_grad_from_state: recompute where the stored value
        # is not finite (the first iteration)
        redo = ~np.isfinite(self.value)
        if redo.any():
            v, g = self.value_and_grad(self.x)
            mask = self._mask(redo)
            self.grad = torch.where(mask[:, None], g, self.grad)
            self.value = _where(redo, v.cpu().numpy(), self.value)
        value, grad = self.value, self.grad

        better = value < self.f_best
        self.x_best = torch.where(self._mask(better)[:, None], self.x,
                                  self.x_best)
        self.f_best = _where(better, value, self.f_best)

        u = self._direction(grad)
        stepsize, self.value, self.grad = self._linesearch(value, grad, u, B)
        step = torch.from_numpy(stepsize).to(self.x.device)
        self.x = self.x + step[:, None] * u

    def _trial(self, stepsize, u):
        """Value, gradient and slope along u at x + stepsize * u."""
        s = torch.from_numpy(stepsize).to(self.x.device)[:, None]
        v, g = self.value_and_grad(self.x + s * u)
        return v, g, torch.sum(g * u, -1)

    def _linesearch(self, value, grad, u, B):
        """optax's zoom linesearch on every element; returns the accepted
        step sizes (host), values (host) and gradients (device)."""
        f = _F
        # the first trial of every element is the search phase's guess, 1:
        # its slope at 0 comes back with the trial's values
        v, g, sl = self._trial(np.ones(B, f), u)
        slope0 = torch.sum(u * grad, -1)
        v, sl, slope_init = torch.stack([v, sl, slope0]).cpu().numpy()
        value_init = value

        count = np.zeros(B, np.int64)
        st = dict(
            stepsize=np.zeros(B, f), value=value.copy(), slope=slope_init,
            interval_found=np.zeros(B, bool), done=np.zeros(B, bool),
            failed=np.zeros(B, bool), dec=np.full(B, np.inf, f),
            low=np.zeros(B, f), value_low=value.copy(),
            slope_low=slope_init.copy(), high=np.zeros(B, f),
            value_high=value.copy(), slope_high=slope_init.copy(),
            cubic_ref=np.zeros(B, f), value_cubic_ref=value.copy(),
            safe_stepsize=np.zeros(B, f), safe_value=value.copy())
        cur_grad, safe_grad = grad, grad
        trial_step = np.ones(B, f)
        active = np.ones(B, bool)
        while True:
            new, upd_safe = self._update(st, count, trial_step, v, sl,
                                         value_init, slope_init)
            # the safe step of an element whose search failed
            fail = new["failed"]
            use_safe = fail & ((new["safe_stepsize"] > 0.0)
                               | np.isinf(new["dec"]))
            new["stepsize"] = _where(use_safe, new["safe_stepsize"],
                                     new["stepsize"])
            new["value"] = _where(use_safe, new["safe_value"], new["value"])
            masks = self._mask(np.stack([active, active & upd_safe,
                                         active & use_safe]))[..., None]
            cur_grad = torch.where(masks[0], g, cur_grad)
            safe_grad = torch.where(masks[1], g, safe_grad)
            cur_grad = torch.where(masks[2], safe_grad, cur_grad)
            for k, val in new.items():
                st[k] = np.where(active, val, st[k]).astype(st[k].dtype)
            count = np.where(active, count + 1, count)
            active = ~(st["done"] | st["failed"])
            if not active.any():
                break
            trial_step = self._next_trial(st, count)
            v, g, sl = self._trial(trial_step, u)
            v, sl = torch.stack([v, sl]).cpu().numpy()
        self.linesearch_steps.append(count)
        return st["stepsize"], st["value"], cur_grad

    @staticmethod
    def _next_trial(st, count):
        """The step size each element tries next: the search phase doubles
        it, the zoom phase interpolates inside the bracket (cubic, else
        quadratic, else bisection)."""
        with np.errstate(all="ignore"):
            search = np.where(count == 0, _F(1.0),
                              _F(INCREASE_FACTOR) * st["stepsize"])
            low, high = st["low"], st["high"]
            delta = np.abs(high - low)
            left, right = np.minimum(high, low), np.maximum(high, low)
            cubic = _cubicmin(low, st["value_low"], st["slope_low"], high,
                              st["value_high"], st["cubic_ref"],
                              st["value_cubic_ref"])
            use_cubic = ((cubic > left + _F(0.2) * delta)
                         & (cubic < right - _F(0.2) * delta))
            quad = _quadmin(low, st["value_low"], st["slope_low"], high,
                            st["value_high"])
            use_quad = ~use_cubic & ((quad > left + _F(0.1) * delta)
                                     & (quad < right - _F(0.1) * delta))
            middle = np.where(use_cubic, cubic, st["cubic_ref"])
            middle = np.where(use_quad, quad, middle)
            middle = np.where(~use_cubic & ~use_quad,
                              (low + high) / _F(2.0), middle)
            return _where(st["interval_found"], middle, search)

    @staticmethod
    def _update(st, count, step, v, sl, value_init, slope_init):
        """One step of optax's zoom linesearch after the trial at `step`
        gave value v and slope sl: the search phase (Nocedal and Wright's
        Algorithm 3.5) where no bracket is found yet, the zoom phase
        (Algorithm 3.6) inside it. Returns the new state and where the
        trial becomes the safe step."""
        f = _F
        with np.errstate(all="ignore"):
            dec = _decrease_error(step, v, sl, value_init, slope_init)
            curv = _curvature_error(sl, slope_init)
        err = np.maximum(dec, curv)
        safe_dec = dec <= 0.0
        done = err <= 0.0
        last = count + 1 >= MAX_LINESEARCH_STEPS
        zoom = st["interval_found"]
        low, value_low, slope_low = st["low"], st["value_low"], st["slope_low"]
        high, value_high, slope_high = (st["high"], st["value_high"],
                                        st["slope_high"])

        # search phase
        s_high_new = (dec > 0.0) | ((v >= st["value"]) & (count > 0))
        s_low_new = (sl >= 0.0) & ~s_high_new
        s = dict(
            low=_where(s_low_new, step, st["stepsize"]),
            value_low=_where(s_low_new, v, st["value"]),
            slope_low=_where(s_low_new, sl, st["slope"]),
            high=_where(s_low_new, st["stepsize"], step),
            value_high=_where(s_low_new, st["value"], v),
            slope_high=_where(s_low_new, st["slope"], sl))
        s["cubic_ref"], s["value_cubic_ref"] = s["low"], s["value_low"]
        s_found = s_high_new | s_low_new | done
        s_upd_safe = safe_dec

        # zoom phase
        z_high_mid = (dec > 0.0) | (v >= value_low)
        z_high_low = (sl * (high - low) >= 0.0) & ~z_high_mid
        nh = _where(z_high_mid, step, high)
        nvh = _where(z_high_mid, v, value_high)
        nsh = _where(z_high_mid, sl, slope_high)
        z_ref_high = z_high_mid | z_high_low
        z = dict(
            high=_where(z_high_low, low, nh),
            value_high=_where(z_high_low, value_low, nvh),
            slope_high=_where(z_high_low, slope_low, nsh),
            low=_where(~z_high_mid, step, low),
            value_low=_where(~z_high_mid, v, value_low),
            slope_low=_where(~z_high_mid, sl, slope_low),
            cubic_ref=_where(z_ref_high, high, low),
            value_cubic_ref=_where(z_ref_high, value_high, value_low))
        z_upd_safe = safe_dec & (v < st["safe_value"])

        upd_safe = np.where(zoom, z_upd_safe, s_upd_safe)
        safe_stepsize = _where(upd_safe, step, st["safe_stepsize"])
        too_small = np.abs(high - low) <= f(INTERVAL_THRESHOLD)
        z_failed = (last | (too_small & (safe_stepsize > 0.0))) & ~done
        new = {k: _where(zoom, z[k], s[k]) for k in s}
        new.update(
            stepsize=step.astype(f), value=v.astype(f), slope=sl.astype(f),
            dec=dec.astype(f),
            interval_found=np.where(zoom, True, s_found), done=done,
            failed=np.where(zoom, z_failed, last & ~done),
            safe_stepsize=safe_stepsize,
            safe_value=_where(upd_safe, v, st["safe_value"]))
        return new, upd_safe


def lbfgs_minimize(energy_fn, x0, max_iter: int = 150, batch_dims: int = 1,
                   solver_log=None):
    """Minimize `energy_fn` from x0 for `max_iter` L-BFGS iterations and
    return the best iterate of each element (strictly lower value wins; the
    final iterate replaces it when its value is lower still). The
    iterations stop early once no element can change any more (every
    iterate non-finite).

    The first `batch_dims` dims of x0 are the batch; `energy_fn` maps
    tensors of x0's shape to energies of the batch's shape. With
    `solver_log` (a list), the finished solver is appended to it.
    """
    flat = x0.reshape((-1,) + tuple(x0.shape[batch_dims:]))
    solver = LBFGS(lambda x: energy_fn(x.view(x0.shape)).reshape(-1), flat)
    for _ in range(max_iter):
        solver.step()
        # An element whose iterate holds a non-finite entry (a NaN gradient
        # sent it there) keeps one: every trial point is non-finite, each
        # linesearch fails and takes the safe step 0, and its value and best
        # stay as they are. Once every element is there, the remaining
        # iterations (20 evaluations each) change nothing.
        if not bool(torch.isfinite(solver.x).all(-1).any()):
            break
    # the value the last linesearch accepted is the energy at the final x
    last = solver.value < solver.f_best
    out = torch.where(solver._mask(last)[:, None], solver.x, solver.x_best)
    if solver_log is not None:
        solver_log.append(solver)
    return out.view(x0.shape)
