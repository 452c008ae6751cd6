"""Restrained minimization: 6D maps -> 3D backbone (counterpart of
text2protein_tpu/realize/minimize.py).

Two cooperating protocols, batched on the device over restarts (and, in
`realize_batch`, over designs):

1. **Distance-geometry + Cartesian (default).** Shortest-path-completed
   classical MDS on the distance map gives a CA trace up to mirror symmetry
   (numpy and scipy on the host); both mirrors plus perturbed copies are
   minimized in Cartesian space — restraints + clash + covalent geometry +
   Ramachandran prior + backbone H-bond well — then idealized with a
   tightened bonded term. The chirality-sensitive theta/omega restraints
   select the correct mirror by energy.

2. **Torsion-space staged protocol (motif scaffolding).** Ramachandran
   random init, staged short/medium/long sequence-separation restraints,
   L-BFGS, weight ladders over restarts. Used when input torsions must be
   clamped (motif scaffolding).

The random draws are explicit: `minimize_cartesian` takes the numpy seed of
its restart starts, `minimize_torsions` its initial torsions and jitter (or
a torch.Generator that draws them). `run_minimization(seed=s)` uses s as
that numpy seed and seeds the generator with s; the JAX package derives
both from `jax.random.PRNGKey(s)` instead, so the two packages start from
different draws for the same seed.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..data.pdbio import write_backbone_pdb
from .geometry import build_backbone, dihedral4, random_dihedrals
from .lbfgs import lbfgs_minimize
from .restraints import (
    Restraints,
    bonded_energy,
    ca_coordinate_energy,
    clash_energy,
    hbond_energy,
    inverse_scale,
    long_dist_energy,
    rama_energy,
    rama_energy_cartesian,
    restraint_energy,
    restraints_from_maps,
)

# Weight ladders: key = run index, default for later runs = last value.
VDW_WEIGHT = {0: 3.0, 1: 5.0, 2: 10.0}
RSR_DIST_WEIGHT = {0: 3.0, 1: 2.0, 3: 1.0}
RSR_ORIENT_WEIGHT = {0: 1.0, 1: 1.0, 3: 0.5}

STAGES = (12.0, 24.0, 1e9)  # short / medium / long seq-sep uppers (cumulative)

# term weights (rama 1.0, cen_hb 5.0; omega 0.5 is inside bonded_energy's
# omega_std scaling)
W_RAMA = 1.0
W_HBOND = 5.0

UNIT = {"dist": 1.0, "orient": 1.0}


# --------------------------------------------------------------------------
# Distance-geometry initialization (host)
# --------------------------------------------------------------------------


def dist_geometry_init(dist_abs: np.ndarray, missing_cutoff: float = 19.5):
    """CA trace from a (L, L) absolute distance map via shortest-path-
    completed classical MDS.

    Entries at the featurizer clamp (dmax=20) carry no information and are
    treated as missing; missing distances are filled with graph shortest
    paths (scipy's Dijkstra over known edges incl. the 3.8 A chain bond),
    then classical MDS (double-centered Gram eigendecomposition) embeds in
    3-D. The result is defined up to reflection — callers consider both
    mirrors.
    """
    from scipy.sparse.csgraph import shortest_path

    D = np.asarray(dist_abs, np.float64).copy()
    L = D.shape[0]
    np.fill_diagonal(D, 0.0)
    missing = D >= missing_cutoff
    for i in range(L - 1):
        D[i, i + 1] = D[i + 1, i] = min(D[i, i + 1], 3.8)
        missing[i, i + 1] = missing[i + 1, i] = False
    # dense-graph semantics: 0 means NO edge — clamp genuine near-zero
    # distances to a positive floor so they stay edges
    Dc = shortest_path(
        np.where(missing, 0.0, np.maximum(D, 1e-3)), method="D",
        directed=False,
    )
    J = np.eye(L) - 1.0 / L
    B = -0.5 * J @ (Dc**2) @ J
    w, V = np.linalg.eigh(B)
    X = V[:, -3:] * np.sqrt(np.maximum(w[-3:], 0.0))
    return X.astype(np.float32)


def ca_trace_to_backbone(ca: np.ndarray) -> np.ndarray:
    """Deterministic N/CA/C backbone from a CA trace: N toward the previous
    CA and C toward the next, tilted out of the local bisector plane
    (Cartesian minimization immediately fixes the covalent geometry)."""
    ca = np.asarray(ca, np.float64)
    prev = np.vstack([2 * ca[0] - ca[1], ca[:-1]])
    nxt = np.vstack([ca[1:], 2 * ca[-1] - ca[-2]])
    u = prev - ca
    u /= np.linalg.norm(u, axis=1, keepdims=True) + 1e-9
    v = nxt - ca
    v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-9
    na = np.cross(u, v)
    na /= np.linalg.norm(na, axis=1, keepdims=True) + 1e-9
    bis = u + v
    bis /= np.linalg.norm(bis, axis=1, keepdims=True) + 1e-9
    nd = 0.5 * u + 0.5 * bis + 0.3 * na
    nd /= np.linalg.norm(nd, axis=1, keepdims=True) + 1e-9
    cd = 0.5 * v + 0.5 * bis - 0.3 * na
    cd /= np.linalg.norm(cd, axis=1, keepdims=True) + 1e-9
    return np.stack(
        [ca + 1.46 * nd, ca, ca + 1.52 * cd], axis=1
    ).astype(np.float32)


def _restart_starts(dist_abs: np.ndarray, L: int, n_restarts: int,
                    seed: int) -> np.ndarray:
    """(R, L, 3, 3) restart backbones: [MDS trace, its mirror] + the MDS
    trace perturbed (+-2 A Gaussian on the CAs) in alternating hands."""
    ca = dist_geometry_init(dist_abs)
    mirror = ca * np.array([1.0, 1.0, -1.0], np.float32)
    starts = [ca_trace_to_backbone(ca), ca_trace_to_backbone(mirror)]
    rng = np.random.RandomState(seed)
    for k in range(max(n_restarts - 2, 0)):
        base = ca if k % 2 else mirror
        starts.append(
            ca_trace_to_backbone(
                base + rng.randn(L, 3).astype(np.float32) * 2.0
            )
        )
    return np.stack(starts)


# --------------------------------------------------------------------------
# Cartesian protocol
# --------------------------------------------------------------------------


def e_fold(bb, rst: Restraints):
    """The restraint-dominated fold stage's energy."""
    return (
        restraint_energy(bb, rst, 1e9, {"dist": 3.0, "orient": 1.0})
        + 3.0 * clash_energy(bb)
        + 0.2 * bonded_energy(bb)
        + W_RAMA * rama_energy_cartesian(bb)
        + W_HBOND * hbond_energy(bb)
        + 1.0 * long_dist_energy(bb, rst)
    )


def e_ideal(bb, rst: Restraints):
    """The geometry-tightened idealization stage's energy."""
    return (
        restraint_energy(bb, rst, 1e9, {"dist": 1.0, "orient": 0.5})
        + 3.0 * clash_energy(bb)
        + 2.0 * bonded_energy(bb, len_std=0.01, ang_std=0.017,
                              omega_std=0.05)
        + W_RAMA * rama_energy_cartesian(bb)
        + W_HBOND * hbond_energy(bb)
        + 0.5 * long_dist_energy(bb, rst)
    )


def selection_energy(bb, rst: Restraints):
    """Restraints at unit weights plus clash: the energy restarts and
    designs are ranked by."""
    return restraint_energy(bb, rst, 1e9, UNIT) + clash_energy(bb)


def _cartesian_refine(bb0, rst: Restraints, max_iter: int, batch_dims=1,
                      solver_log=None):
    """Two-stage Cartesian minimization of a batch of starting backbones
    ((*batch, L, 3, 3), `batch_dims` leading dims): restraint-dominated fold
    stage, then geometry-tightened idealization. Returns (bb, selection
    energies (*batch,))."""
    bb = lbfgs_minimize(lambda b: e_fold(b, rst), bb0, max_iter,
                        batch_dims, solver_log)
    bb = lbfgs_minimize(lambda b: e_ideal(b, rst), bb,
                        max(max_iter * 2 // 3, 50), batch_dims, solver_log)
    with torch.no_grad():
        return bb, selection_energy(bb, rst)


def minimize_cartesian(rst: Restraints, dist_abs: np.ndarray, L: int,
                       n_restarts: int = 5, max_iter: int = 300,
                       seed: int = 0, solver_log=None):
    """Distance-geometry + Cartesian protocol (see module docstring).

    Restarts = [MDS, MDS-mirror] + (n_restarts - 2) perturbed MDS traces
    drawn from numpy seed `seed`, minimized as one batch on rst's device;
    lowest selection energy wins.
    Returns (bb (L, 3, 3), best_energy, all_energies (R,)).
    """
    bb0 = torch.from_numpy(_restart_starts(dist_abs, L, n_restarts, seed))
    bbs, energies = _cartesian_refine(bb0.to(rst.dist.device), rst,
                                      max_iter, solver_log=solver_log)
    best = torch.argmin(energies)
    return bbs[best], energies[best], energies


# --------------------------------------------------------------------------
# Torsion-space staged protocol (motif scaffolding)
# --------------------------------------------------------------------------


def torsion_draws(L: int, n_restarts: int, generator, device="cpu"):
    """The torsion protocol's random start: (phi, psi, jitter_phi,
    jitter_psi), each (R, L): Ramachandran-bin torsions and +-10 degree
    uniform jitter (applied to restarts after the first)."""
    phi, psi, _ = random_dihedrals(L, generator, (n_restarts,), device)
    lim = math.radians(10.0)
    jit = [torch.rand((n_restarts, L), generator=generator, device=device)
           * (2 * lim) - lim for _ in range(2)]
    return phi, psi, jit[0], jit[1]


def minimize_torsions(rst: Restraints, L: int, n_restarts: int = 5,
                      max_iter: int = 150, fixed_torsions=None,
                      design_mask=None, draws=None, generator=None,
                      solver_log=None):
    """Run the full staged multi-restart torsion protocol; returns (bb,
    best energy, energies (R,)). All restarts run as one batch on rst's
    device.

    The start is `draws` ((phi, psi, jitter_phi, jitter_psi), each (R, L),
    as `torsion_draws` returns) or drawn with `generator`.

    Motif scaffolding: with `fixed_torsions` ((2, L) phi/psi) and
    `design_mask` ((L,) bool, True = redesign), non-design torsions are
    clamped to the input pose and only the masked spans are optimized.
    """
    dev = rst.dist.device
    R = n_restarts
    if draws is None:
        draws = torsion_draws(L, R, generator, dev)
    phi, psi, jit_phi, jit_psi = (torch.as_tensor(d, dtype=torch.float32)
                                  .to(dev) for d in draws)
    if design_mask is None:
        design_mask = torch.ones((L,), dtype=torch.bool, device=dev)
    design2 = torch.as_tensor(design_mask, device=dev)[None, :].expand(2, L)
    if fixed_torsions is not None:
        fixed_torsions = torch.as_tensor(fixed_torsions,
                                         dtype=torch.float32).to(dev)

    def clamp(x):
        if fixed_torsions is None:
            return x
        return torch.where(design2, x, fixed_torsions)

    # perturbation on restarts after the first: +/- 10 degrees
    jitter = (torch.arange(R, device=dev) > 0).to(torch.float32)[:, None]
    x = clamp(torch.stack([phi + jitter * jit_phi, psi + jitter * jit_psi],
                          dim=1))  # (R, 2, L)

    def ladder(table, default):
        return torch.tensor([table.get(r, default) for r in range(R)],
                            dtype=torch.float32, device=dev)

    w_vdw = ladder(VDW_WEIGHT, 10.0)
    w_dist = ladder(RSR_DIST_WEIGHT, 1.0)
    w_orient = ladder(RSR_ORIENT_WEIGHT, 0.5)

    def energy(x, sep_max):
        xc = clamp(x)
        bb = build_backbone(xc[:, 0], xc[:, 1])
        e = restraint_energy(bb, rst, sep_max,
                             {"dist": w_dist, "orient": w_orient})
        e = e + W_RAMA * rama_energy(xc[:, 0], xc[:, 1])
        e = e + W_HBOND * hbond_energy(bb)
        return e + w_vdw * clash_energy(bb)

    # staged schedule: short -> +medium -> +long (cumulative bands)
    for sep_max in STAGES:
        x = lbfgs_minimize(lambda t, s=sep_max: energy(t, s), x, max_iter,
                           solver_log=solver_log)

    with torch.no_grad():
        x = clamp(x)
        bbs = build_backbone(x[:, 0], x[:, 1])
        # final scoring at unit weights over all bands
        energies = selection_energy(bbs, rst)
    best = torch.argmin(energies)
    return bbs[best], energies[best], energies


def _torsions_from_backbone(bb):
    """Measure (phi, psi, omega) from (..., L, 3, 3) backbone coords
    (inverse of build_backbone; first phi / last psi default to the
    canonical values)."""
    n, ca, c = bb[..., 0, :], bb[..., 1, :], bb[..., 2, :]
    lead = bb.shape[:-3] + (1,)

    def const(v):
        return torch.full(lead, v, dtype=bb.dtype, device=bb.device)

    phi = torch.cat([const(-math.pi / 3),
                     dihedral4(c[..., :-1, :], n[..., 1:, :],
                               ca[..., 1:, :], c[..., 1:, :])], dim=-1)
    psi = torch.cat([dihedral4(n[..., :-1, :], ca[..., :-1, :],
                               c[..., :-1, :], n[..., 1:, :]),
                     const(math.pi / 3)], dim=-1)
    omega = torch.cat([const(math.pi),
                       dihedral4(ca[..., :-1, :], c[..., :-1, :],
                                 n[..., 1:, :], ca[..., 1:, :])], dim=-1)
    return phi, psi, omega


def relax_backbone(bb0, rst: Restraints, max_iter: int = 100,
                   crd_std: float = 1.0, crd_tol: float = 1.0,
                   solver_log=None):
    """Relax stage (FastRelax-equivalent final polish): re-minimize all
    restraints at unit weights PLUS flat-harmonic CA coordinate restraints
    anchored to the input pose, in Cartesian space with the full centroid
    term set. bb0: (L, 3, 3), or (B, L, 3, 3) with rst broadcasting.
    Returns (bb, energy)."""
    batched = bb0.dim() == 4
    x0 = bb0 if batched else bb0[None]
    ca_ref = x0[..., 1, :].detach()

    def energy(bb):
        e = restraint_energy(bb, rst, 1e9, UNIT)
        e = e + clash_energy(bb)
        e = e + 2.0 * bonded_energy(bb, len_std=0.01, ang_std=0.017,
                                    omega_std=0.05)
        e = e + W_RAMA * rama_energy_cartesian(bb)
        e = e + W_HBOND * hbond_energy(bb)
        e = e + 0.5 * long_dist_energy(bb, rst)
        return e + ca_coordinate_energy(bb, ca_ref, std=crd_std,
                                        tol=crd_tol)

    bb = lbfgs_minimize(energy, x0, max_iter, solver_log=solver_log)
    with torch.no_grad():
        e = energy(bb)
    return (bb, e) if batched else (bb[0], e[0])


def run_minimization(
    npz: dict,
    seq: str,
    outPath=None,
    seed: int = 0,
    n_restarts: int = 5,
    angle_std: float = 10.0,
    dist_std: float = 2.0,
    max_iter: int = 150,
    use_fastrelax: bool = True,
    pose_bb=None,
    method: str = "cartesian",
    device=None,
    solver_log=None,
):
    """Absolute-unit restraint maps + sequence -> minimized backbone written
    as PDB. With `use_fastrelax`, a final CA-coordinate-restrained relax
    round runs on the best pose.

    `method`: "cartesian" (default; distance-geometry init + Cartesian
    refinement) or "torsion" (staged torsion protocol). Motif scaffolding
    (`pose_bb` + '_'-masked `seq`) always uses the torsion protocol, which
    can clamp fixed torsions exactly. `seed` seeds the restart draws (see
    the module docstring). Runs on `device` (default CUDA).

    Returns (backbone (L, 3, 3) np.ndarray, best_energy, all_energies).
    """
    dev = resolve_device(device)
    L = len(seq)
    rst = restraints_from_maps(npz, dist_std=dist_std, angle_std=angle_std,
                               device=dev)
    if pose_bb is not None or method == "torsion":
        fixed_torsions = None
        design_mask = None
        if pose_bb is not None:
            phi0, psi0, _ = _torsions_from_backbone(
                torch.as_tensor(np.asarray(pose_bb, np.float32)).to(dev))
            fixed_torsions = torch.stack([phi0, psi0], dim=0)
            design_mask = torch.tensor([c == "_" for c in seq], device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        bb, e_best, energies = minimize_torsions(
            rst, L, n_restarts, max_iter, fixed_torsions=fixed_torsions,
            design_mask=design_mask, generator=gen, solver_log=solver_log)
    else:
        bb, e_best, energies = minimize_cartesian(
            rst, npz["dist_abs"], L, n_restarts=n_restarts,
            max_iter=max(max_iter * 2, 200), seed=seed,
            solver_log=solver_log)
    e_best = float(e_best)
    if outPath is not None:
        outPath = Path(outPath)
        outPath.mkdir(parents=True, exist_ok=True)
        write_backbone_pdb(outPath / "structure_before_design.pdb",
                           bb.cpu().numpy(), seq=seq)

    if use_fastrelax:
        bb_rel, _ = relax_backbone(bb, rst, max_iter=max_iter,
                                   solver_log=solver_log)
        with torch.no_grad():
            e_rel_sel = float(selection_energy(bb_rel, rst))
        if e_rel_sel < e_best:
            bb, e_best = bb_rel, e_rel_sel
        if outPath is not None:
            write_backbone_pdb(outPath / "final_structure.pdb",
                               bb.cpu().numpy(), seq=seq)

    return bb.cpu().numpy(), e_best, energies.cpu().numpy()


def realize_batch(samples_cnn, n_restarts: int = 5, max_iter: int = 300,
                  seed: int = 0, angle_std: float = 10.0,
                  dist_std: float = 2.0, device=None, solver_log=None):
    """Batched realization: D same-length designs minimized concurrently on
    the device — restarts AND designs in one batch. Uses the Cartesian
    protocol with distance-geometry initialization; design k's restarts
    are drawn from numpy seed `seed + 31 k`.

    Args:
      samples_cnn: (D, C, N, N) sampled maps, all with the same real length.
    Returns:
      (backbones (D, L, 3, 3), best energies (D,)), numpy.
    """
    dev = resolve_device(device)
    samples_cnn = np.asarray(samples_cnn)
    msk0 = np.round(samples_cnn[0, -1])
    L = int(round(np.sqrt((msk0 == 1).sum())))
    rsts, starts = [], []
    for s in samples_cnn:
        npz = inverse_scale(s, L)
        rsts.append(restraints_from_maps(npz, dist_std=dist_std,
                                         angle_std=angle_std, device=dev))
        starts.append(
            _restart_starts(npz["dist_abs"], L, n_restarts,
                            seed + 31 * len(starts))
        )
    # (D, 1, L, L): each design's restraints serve its R restarts
    rst = Restraints.stack(rsts).map(lambda t: t[:, None])
    bb0 = torch.from_numpy(np.stack(starts)).to(dev)  # (D, R, L, 3, 3)
    bbs, energies = _cartesian_refine(bb0, rst, max_iter, batch_dims=2,
                                      solver_log=solver_log)
    best = torch.argmin(energies, dim=1)
    idx = torch.arange(len(samples_cnn), device=dev)
    return bbs[idx, best].cpu().numpy(), energies[idx, best].cpu().numpy()


def realize_batch_managed(samples_cnn, n_restarts: int = 5,
                          max_iter: int = 300, seed: int = 0,
                          retry_factor: float = 3.0, max_retries: int = 2,
                          **kwargs):
    """`realize_batch` + tail management: designs whose selection energy
    exceeds `retry_factor` x the batch median are re-realized with fresh
    restart seeds (`seed + 7919 attempt`), keeping the best outcome per
    design. Designs still above the threshold after `max_retries` are
    flagged.

    Returns (backbones (D, L, 3, 3), energies (D,), flags (D,) bool —
    True = realization still high-energy after retries).
    """
    samples_cnn = np.asarray(samples_cnn)
    bbs, energies = realize_batch(samples_cnn, n_restarts=n_restarts,
                                  max_iter=max_iter, seed=seed, **kwargs)
    # the retry loop writes per-design improvements in place
    bbs, energies = np.array(bbs), np.array(energies)
    for attempt in range(1, max_retries + 1):
        med = float(np.median(energies))
        bad = energies > retry_factor * max(med, 1e-6)
        if not bad.any():
            break
        idx = np.nonzero(bad)[0]
        # the full batch again (the JAX package keeps one compiled shape);
        # improvements are kept only at the flagged indices
        bbs_r, es_r = realize_batch(
            samples_cnn, n_restarts=n_restarts, max_iter=max_iter,
            seed=seed + 7919 * attempt, **kwargs,
        )
        for i in idx:
            if es_r[i] < energies[i]:
                bbs[i], energies[i] = bbs_r[i], es_r[i]
    med = float(np.median(energies))
    flags = energies > retry_factor * max(med, 1e-6)
    return bbs, energies, flags


def realize_6d_sample(coords_6d_cnn: np.ndarray, seq: str | None = None,
                      **kwargs):
    """One-call path from a sampled (C, N, N) map to a backbone (the
    realization CLI's per-design body)."""
    msk = np.round(coords_6d_cnn[-1])
    L = int(round(np.sqrt((msk == 1).sum())))
    npz = inverse_scale(coords_6d_cnn, L)
    if seq is None:
        seq = "A" * L  # polyalanine
    return run_minimization(npz, seq, **kwargs)
