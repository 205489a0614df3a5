"""Markov-chain Monte Carlo equilibrium sampler for rigid bodies (PyTorch).

Counterpart of rigidmultiblobswall_tpu/models/mcmc.py: Metropolis-Hastings
over body locations and orientations with uniform translation and
Gaussian-rotation proposals, and the independent-sample rejection sampler.
The total energy is gravity + wall repulsion per blob, with a 1e5 (1 - z)
penalty for blobs behind the wall, + the blob-blob soft repulsion summed
over pairs by kernel M1 (ops/forces.blob_blob_energy) on the card and its
plain version on the CPU, in float64 whatever the positions' dtype.

The draws are torch's, from an explicit torch.Generator on the state's
device. Every step also takes its draws as arguments (`Draws`,
`RejectionDraws`), so a caller can feed the JAX package's. The chain keeps
its accept on the device (torch.where): a run makes no host sync between
saved frames. The rejection sampler evaluates its proposals in batches
through M1, where the JAX package scans them one at a time.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import forces as force_ops
from ..ops import quaternion as quat
from . import kinematics as kin
from .system import State, System, resolve_device


# proposals the rejection sampler draws and evaluates at a time (one M1
# launch a batch on the card)
REJECTION_BATCH = 4096


def _max_body_length(system: System):
    return max(t.body_length + 2 * system.blob_radius for t in system.types)


def _to_device(array, dtype, device):
    """A host array on `device` without a host sync: a CUDA copy goes from
    pinned memory, asynchronously on the current stream."""
    t = torch.as_tensor(np.array(array), dtype=dtype)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class _Energy:
    """Energies of batches of configurations of `system`, with the body
    types' reference blobs and the free-body mask kept on each device and
    dtype they are asked for (copied once, so a step makes no host
    copy)."""

    def __init__(self, system: System):
        self.system = system
        self._tensors = {}

    def tensors(self, dtype, device):
        key = (dtype, str(device))
        if key not in self._tensors:
            self._tensors[key] = (
                [_to_device(t.ref_config, dtype, device)
                 for t in self.system.types],
                _to_device(~self.system.prescribed_body_mask, dtype,
                           device)[:, None])
        return self._tensors[key]

    def one_body(self, r):
        """The one-body terms of blobs r (P, N, 3) summed in float64, (P,):
        gravity and the wall repulsion, and the 1e5 (1 - z) penalty below
        the wall."""
        s = self.system
        z = r[..., 2]
        a = s.blob_radius
        eps_w, b_w = s.repulsion_strength_wall, s.debye_length_wall
        u_one = s.g * z + torch.where(
            z < a, eps_w + eps_w * (a - z) / b_w,
            eps_w * torch.exp(-(z - a) / b_w))
        u_one = torch.where(z > 0, u_one, 1e5 * (1.0 - z))
        return u_one.sum(dim=-1, dtype=torch.float64)

    def __call__(self, pos, q):
        """U of each configuration, pos (P, B, 3) and q (P, B, 4) -> (P,)
        float64 (the JAX package's total_energy of each)."""
        s = self.system
        refs, _ = self.tensors(pos.dtype, pos.device)
        r = kin.blob_positions(s, State(pos=pos, quat=q), refs=refs)
        pair = force_ops.blob_blob_energy(
            r, repulsion_strength=s.repulsion_strength,
            debye_length=s.debye_length, blob_radius=s.blob_radius,
            periodic_length=s.periodic_length, coincident="one")
        return self.one_body(r) + pair


def total_energy(system: System, state: State):
    """U = sum_i [g z_i + U_wall(z_i)] + sum_{i<j} U_bb(r_ij), with a
    1e5 (1 - z) penalty for blobs below the wall; a float64 scalar. The
    pair sum masks only the diagonal: distinct coincident blobs count at
    r = 1, as in the JAX package."""
    return _Energy(system)(state.pos[None], state.quat[None])[0]


class MCMCState(NamedTuple):
    state: State
    energy: torch.Tensor           # float64 scalar
    accepted: torch.Tensor         # int64 scalar
    # the adaptive proposal size and its EWMA acceptance tracker (ratio <-
    # 0.95 ratio + 0.05 on accept; during the first half of burn-in d <- d
    # 1.02 if ratio > 0.5 else d 0.98), scalars in the state's dtype
    max_translation: torch.Tensor = None
    acc_ratio: torch.Tensor = None


class Draws(NamedTuple):
    """The draws of one Metropolis step: dx (B, 3) uniform in [-1, 1),
    dphi (B, 3) standard normal, u () uniform in [0, 1)."""
    dx: torch.Tensor
    dphi: torch.Tensor
    u: torch.Tensor


def draw(system: System, generator, dtype, device) -> Draws:
    """One step's draws from `generator` (on `device`)."""
    shape = (system.num_bodies, 3)
    dx = 2.0 * torch.rand(shape, generator=generator, dtype=dtype,
                          device=device) - 1.0
    dphi = torch.randn(shape, generator=generator, dtype=dtype,
                       device=device)
    u = torch.rand((), generator=generator, dtype=dtype, device=device)
    return Draws(dx, dphi, u)


def make_mcmc_kernel(system: System):
    """One Metropolis step: kernel(mc, generator, adapt=False, draws=None)
    -> MCMCState. Proposal: translation d dx and rotation exp(dphi d /
    L_max) of every free body (prescribed bodies stay), with d carried in
    the state so burn-in can adapt it (init_mcmc sets it); accept when
    log u < -(E_new - E) / kT, on the device. `draws` (Draws) replaces the
    generator's."""
    max_len = _max_body_length(system)
    energy = _Energy(system)

    def kernel(mc: MCMCState, generator=None, adapt=False,
               draws=None) -> MCMCState:
        pos, q = mc.state.pos, mc.state.quat
        if draws is None:
            draws = draw(system, generator, pos.dtype, pos.device)
        _, free = energy.tensors(pos.dtype, pos.device)
        d = mc.max_translation
        pos_new = pos + free * (draws.dx * d)
        q_new = quat.multiply(
            quat.from_rotation(free * (draws.dphi * (d / max_len))), q)
        e_new = energy(pos_new[None], q_new[None])[0]
        accept = torch.log(draws.u) < -(e_new - mc.energy) / system.kT
        ratio = mc.acc_ratio * 0.95 + 0.05 * accept.to(pos.dtype)
        if adapt:
            d = torch.where(ratio > 0.5, d * 1.02, d * 0.98)
        return MCMCState(
            state=State(pos=torch.where(accept, pos_new, pos),
                        quat=torch.where(accept, q_new, q)),
            energy=torch.where(accept, e_new, mc.energy),
            accepted=mc.accepted + accept.to(torch.int64),
            max_translation=d, acc_ratio=ratio)

    kernel.energy = energy
    return kernel


def init_mcmc(system: System, state: State, max_translation=None,
              energy=None):
    """The chain's start at `state`: its energy (one M1 launch on the
    card; `energy`, a kernel's `.energy`, reuses that kernel's device
    tensors), no move accepted, d = max_translation (0.1 a by default) and
    the acceptance tracker at 0.5."""
    if max_translation is None:
        max_translation = 0.1 * system.blob_radius
    energy = _Energy(system) if energy is None else energy
    dtype, dev = state.pos.dtype, state.pos.device
    return MCMCState(
        state=state, energy=energy(state.pos[None], state.quat[None])[0],
        accepted=torch.zeros((), dtype=torch.int64, device=dev),
        max_translation=torch.full((), float(max_translation), dtype=dtype,
                                   device=dev),
        acc_ratio=torch.full((), 0.5, dtype=dtype, device=dev))


def run_mcmc(system: System, state: State, generator=None, *, n_steps,
             save_every=1, max_translation=None, initial_step=0, draws=None):
    """Run burn-in (-initial_step steps when negative, adapting the
    proposal size over their first half) then the chain; returns (final
    MCMCState, trajectory of saved States stacked (frames, B, ...), their
    energies (frames,) float64). Frame s is the state after s save_every +
    1 moves: frame 0 exists for any n_steps >= 1, and all n_steps moves
    run, the tail past the last frame included. `draws` (an iterable of
    Draws, one a move in order, burn-in first) replaces the generator's.
    The frames stay on the device: no host sync in the run."""
    kernel = make_mcmc_kernel(system)
    mc = init_mcmc(system, state, max_translation=max_translation,
                   energy=kernel.energy)
    feed = iter(draws) if draws is not None else None

    def move(mc, adapt=False):
        return kernel(mc, generator, adapt,
                      next(feed) if feed is not None else None)

    if initial_step < 0:
        flags = np.arange(initial_step, 0) < (initial_step // 2)
        for adapt in flags:
            mc = move(mc, bool(adapt))
    if n_steps < 1:
        pos, q = mc.state.pos, mc.state.quat
        empty = State(pos=pos.new_zeros((0,) + pos.shape),
                      quat=q.new_zeros((0,) + q.shape))
        return mc, empty, mc.energy.new_zeros((0,))
    mc = move(mc)
    frames = [mc]
    for _ in range((n_steps - 1) // save_every):
        for _ in range(save_every):
            mc = move(mc)
        frames.append(mc)
    for _ in range((n_steps - 1) % save_every):
        mc = move(mc)
    traj = State(pos=torch.stack([f.state.pos for f in frames]),
                 quat=torch.stack([f.state.quat for f in frames]))
    return mc, traj, torch.stack([f.energy for f in frames])


class RejectionResult(NamedTuple):
    states: State                  # (n_steps, B, ...) stacked proposals
    accepted: torch.Tensor         # (n_steps,) bool
    minimum_energy: torch.Tensor   # float64 scalar
    energies: torch.Tensor         # (n_steps,) float64


class RejectionDraws(NamedTuple):
    """Fed proposals of the rejection sampler: est_pos (n_estimate, B, 3)
    and est_quat (n_estimate, B, 4) for the minimum-energy estimate, pos
    (n_steps, B, 3), quat (n_steps, B, 4) and u (n_steps,) uniform in [0,
    1) for the samples."""
    est_pos: torch.Tensor
    est_quat: torch.Tensor
    pos: torch.Tensor
    quat: torch.Tensor
    u: torch.Tensor


def run_rejection_sampler(system: System, generator=None, *, n_steps,
                          n_estimate=100000, box_size=None,
                          dtype=torch.float64, device=None, draws=None):
    """Independent-sample rejection sampler: propose uniform positions in
    [0, L)^3 (L = 5 max body length by default) with uniformly random
    orientations; phase 1 estimates the minimum energy over `n_estimate`
    proposals (less kT, a safety factor), phase 2 accepts each of n_steps
    proposals with probability exp(-(E - E_min)/kT). Proposals are drawn
    and evaluated REJECTION_BATCH at a time (one M1 launch a batch on the
    card); `draws` (RejectionDraws, on `device`) replaces the
    generator's."""
    if box_size is None:
        box_size = 5.0 * _max_body_length(system)
    device = resolve_device(device)
    B = system.num_bodies
    energy = _Energy(system)
    batch = REJECTION_BATCH

    def proposals(count):
        pos = torch.rand((count, B, 3), generator=generator, dtype=dtype,
                         device=device) * box_size
        return pos, quat.random(generator, (count, B), dtype=dtype,
                                device=device)

    min_e = torch.full((), float("inf"), dtype=torch.float64, device=device)
    for k0 in range(0, n_estimate, batch):
        count = min(batch, n_estimate - k0)
        pos, q = (proposals(count) if draws is None else
                  (draws.est_pos[k0:k0 + count],
                   draws.est_quat[k0:k0 + count]))
        min_e = torch.minimum(min_e, energy(pos, q).min())
    min_e = min_e - system.kT
    # each list starts empty-shaped, so n_steps = 0 returns empty results
    positions = [torch.zeros((0, B, 3), dtype=dtype, device=device)]
    quats = [torch.zeros((0, B, 4), dtype=dtype, device=device)]
    accepted = [torch.zeros(0, dtype=torch.bool, device=device)]
    energies = [torch.zeros(0, dtype=torch.float64, device=device)]
    for k0 in range(0, n_steps, batch):
        count = min(batch, n_steps - k0)
        if draws is None:
            pos, q = proposals(count)
            u = torch.rand((count,), generator=generator, dtype=dtype,
                           device=device)
        else:
            pos, q = draws.pos[k0:k0 + count], draws.quat[k0:k0 + count]
            u = draws.u[k0:k0 + count]
        e = energy(pos, q)
        positions.append(pos)
        quats.append(q)
        accepted.append(u < torch.exp(-(e - min_e) / system.kT))
        energies.append(e)
    return RejectionResult(
        states=State(pos=torch.cat(positions), quat=torch.cat(quats)),
        accepted=torch.cat(accepted), minimum_energy=min_e,
        energies=torch.cat(energies))
