"""text2protein_tpu_torch.realize.lbfgs against optax.lbfgs() (its
defaults, driven by optax.value_and_grad_from_state as the JAX package's
`_lbfgs_minimize` drives it), iterate by iterate: on a small smooth
function and on the Cartesian fold energy at L=16, batched over restarts
against optax vmapped over them, as the JAX package runs its restarts.

Tolerances: the same linesearch step count on every element at every one
of 20 iterations, and iterates within 1e-5 (Rosenbrock, entries of order 1)
and 5e-5 (the fold energy, coordinates of ~10 A) over the first 10. f32
rounding that differs between XLA and torch grows along the trajectory
(the port batched and the port alone part at the same rate), so later
iterations are held by outcome in test_torch_realize_cartesian.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from text2protein_tpu.data.featurize import featurize_structure
from text2protein_tpu.data.synthetic import helix_bundle_torsions
from text2protein_tpu.realize import geometry as jg
from text2protein_tpu.realize import minimize as jm
from text2protein_tpu.realize import restraints as jr
from text2protein_tpu_torch.realize import lbfgs as tl
from text2protein_tpu_torch.realize import minimize as tm
from text2protein_tpu_torch.realize import restraints as tr


def rosen_j(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


def rosen_t(x):
    return torch.sum(100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2
                     + (1 - x[..., :-1]) ** 2, -1)


def optax_trajectory(fn, x0, n):
    """optax.lbfgs() vmapped over x0's leading dim: (n, *x0.shape)
    iterates and (n, B) linesearch steps."""
    solver = optax.lbfgs()
    value_and_grad = optax.value_and_grad_from_state(fn)

    def step(x, state):
        value, grad = value_and_grad(x, state=state)
        updates, state = solver.update(grad, state, x, value=value,
                                       grad=grad, value_fn=fn)
        return (optax.apply_updates(x, updates), state,
                state[2].info.num_linesearch_steps)

    step = jax.jit(jax.vmap(step))
    x = jnp.asarray(x0)
    state = jax.vmap(solver.init)(x)
    xs, steps = [], []
    for _ in range(n):
        x, state, k = step(x, state)
        xs.append(np.asarray(x))
        steps.append(np.asarray(k))
    return np.stack(xs), np.stack(steps)


ITERS, CLOSE_ITERS = 20, 10


def _hold_to_optax(fn_j, fn_t, x0, atol):
    """The port's batched solver from x0 (B, ...) against optax."""
    xs, steps = optax_trajectory(fn_j, x0, ITERS)
    solver = tl.LBFGS(fn_t, torch.from_numpy(x0))
    for i in range(ITERS):
        solver.step()
        np.testing.assert_array_equal(solver.linesearch_steps[i], steps[i])
        if i < CLOSE_ITERS:
            np.testing.assert_allclose(
                solver.x.numpy().reshape(x0.shape), xs[i], rtol=0,
                atol=atol, err_msg=f"iteration {i}")


def test_lbfgs_matches_optax_on_rosenbrock():
    x0 = np.random.default_rng(0).standard_normal((3, 6)).astype(np.float32)
    _hold_to_optax(rosen_j, rosen_t, x0, 1e-5)


def _fold_problem(L=16):
    phi, psi = helix_bundle_torsions(24, seed=3)
    bb = np.asarray(jg.build_backbone(jnp.asarray(phi),
                                      jnp.asarray(psi)))[:L]
    c6d, _, _ = featurize_structure(bb, np.ones(L), ss_constraints=False)
    npz = jr.inverse_scale(c6d, L)
    rj, rt = jr.restraints_from_maps(npz), tr.restraints_from_maps(npz)

    def e_fold_j(b):
        return (jr.restraint_energy(b, rj, 1e9, {"dist": 3.0, "orient": 1.0})
                + 3.0 * jr.clash_energy(b) + 0.2 * jr.bonded_energy(b)
                + jm.W_RAMA * jr.rama_energy_cartesian(b)
                + jm.W_HBOND * jr.hbond_energy(b)
                + 1.0 * jr.long_dist_energy(b, rj))

    starts = (bb[None] + np.random.default_rng(1).standard_normal(
        (3, L, 3, 3)) * 0.5).astype(np.float32)
    return e_fold_j, (lambda b: tm.e_fold(b, rt)), starts, npz, rj, rt


def test_lbfgs_matches_optax_on_the_fold_energy():
    e_fold_j, e_fold_t, starts, *_ = _fold_problem()
    _hold_to_optax(e_fold_j, e_fold_t, starts, 5e-5)


def test_lbfgs_batched_matches_alone():
    """Each element of a batch takes the linesearch steps it takes alone,
    whatever the others' linesearches do, and its iterates agree to f32
    rounding (batched reductions round differently)."""
    _, e_fold_t, starts, *_ = _fold_problem()
    batched = tl.LBFGS(e_fold_t, torch.from_numpy(starts))
    alone = [tl.LBFGS(e_fold_t, torch.from_numpy(starts[b:b + 1]))
             for b in range(3)]
    for i in range(ITERS):
        batched.step()
        for b, s in enumerate(alone):
            s.step()
            assert batched.linesearch_steps[i][b] == s.linesearch_steps[i][0]
            if i < CLOSE_ITERS:
                np.testing.assert_allclose(batched.x[b].numpy(),
                                           s.x[0].numpy(), rtol=0,
                                           atol=1e-5)


def test_lbfgs_minimize_returns_the_best_iterate():
    """The best-so-far rule of `_lbfgs_minimize`: strictly lower value
    wins, the final iterate replaces the best when lower still; from the
    Cartesian protocol's MDS starts."""
    _, e_fold_t, _, npz, _, rt = _fold_problem()
    starts = torch.from_numpy(jm._restart_starts(npz["dist_abs"], 16, 3, 7))
    n = 12
    solver = tl.LBFGS(lambda b: tm.e_fold(b, rt), starts)
    xs, values = [], []
    for _ in range(n):
        solver.step()
        xs.append(solver.x.clone())
    xs = [starts.reshape(3, -1)] + xs
    with torch.no_grad():
        values = np.stack([tm.e_fold(x.view(starts.shape), rt).numpy()
                           for x in xs])
    got = tl.lbfgs_minimize(lambda b: tm.e_fold(b, rt), starts, n)
    for b in range(3):
        best = int(np.argmin(values[:n, b]))  # first of the lowest
        k = n if values[n, b] < values[best, b] else best
        np.testing.assert_array_equal(got[b].numpy().ravel(),
                                      xs[k][b].numpy())


def test_lbfgs_minimize_matches_jax_lbfgs_minimize():
    x0 = np.random.default_rng(2).standard_normal((6,)).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda x: jm._lbfgs_minimize(rosen_j, x, 8))(jnp.asarray(x0)))
    got = tl.lbfgs_minimize(rosen_t, torch.from_numpy(x0[None]), 8)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_lbfgs_minimize_stops_when_no_element_can_move():
    """On a noise map the Cartesian protocol's MDS starts give NaN
    gradients (in the JAX package too): the first step makes every iterate
    NaN, and from there each linesearch fails after 20 evaluations and
    changes nothing. lbfgs_minimize stops there, with the result of the
    full run: the start, which the first iteration recorded as the best."""
    L = 40
    noise = np.random.default_rng(0).uniform(-1, 1, (5, L, L)).astype(
        np.float32)
    noise[-1] = 1.0
    npz = tr.inverse_scale(noise, L)
    rst = tr.restraints_from_maps(npz)
    starts = torch.from_numpy(jm._restart_starts(npz["dist_abs"], L, 2, 0))

    def fn(b):
        return tm.e_fold(b, rst)

    full = tl.LBFGS(fn, starts)
    for _ in range(4):
        full.step()
    assert [k.tolist() for k in full.linesearch_steps] == [[20, 20]] * 4
    assert not torch.isfinite(full.x).any()
    log = []
    got = tl.lbfgs_minimize(fn, starts, 300, solver_log=log)
    assert len(log[0].linesearch_steps) == 1
    assert torch.equal(got, starts)
    assert torch.equal(got.reshape(2, -1), full.x_best)
