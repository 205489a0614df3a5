"""Triply periodic Brownian suspension on the spectral engine of the
PyTorch port: the twin of examples/periodic_suspension/run.py. A box of
twelve-blob shells on a cubic lattice at spacing 1.6, random
orientations, evolved by stochastic_Slip_Trapz with every mobility
product on the spectral Ewald engine (domain periodic_spectral), then
the radial distribution of the saved frames (utils/gr).

Run:  python -m rigidmultiblobswall_tpu_torch.examples.periodic_suspension_run
          [n_bodies] [n_steps] [--device cuda|cpu]

In float32, on the card unless --device names another; the noise comes
from a torch.Generator seeded with 0. The engine's cell capacity is
sized from the initial configuration, as the CLI sizes it.
"""

import argparse

import numpy as np
import torch

from ..models import integrators, saddle
from ..models.system import BodyType, System, make_state, resolve_device
from ..utils import gr

SPACING = 1.6


def shell(n=12, radius=0.3):
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    th = np.pi * (1 + 5 ** 0.5) * i
    return radius * np.stack([np.cos(th) * np.sin(phi),
                              np.sin(th) * np.sin(phi), np.cos(phi)], axis=1)


def build(n_bodies, device=None):
    """The JAX script's scene in float32: (system, state, box length)."""
    side = int(np.ceil(n_bodies ** (1 / 3)))
    L = side * SPACING
    t = BodyType(name="shell", ref_config=shell(), count=n_bodies)
    system = System(
        types=(t,), eta=1.0, blob_radius=0.1, kT=0.1, g=0.0,
        domain="periodic_spectral", periodic_length=(L, L, L),
        spectral_tol=1e-4, spectral_grid_max=96,
        repulsion_strength=0.1, debye_length=0.2,
        solver_tolerance=1e-4)
    idx = np.arange(n_bodies)
    pos = np.stack([(idx % side), (idx // side) % side,
                    idx // (side * side)], axis=1) * SPACING + 0.8
    rng = np.random.default_rng(0)
    quat = rng.normal(size=(n_bodies, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    state = make_state(pos, quat, dtype=torch.float32, device=device)
    return saddle.auto_spectral_capacities(system, state), state, L


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n_bodies", type=int, nargs="?", default=64)
    p.add_argument("n_steps", type=int, nargs="?", default=50)
    p.add_argument("--device", default=None,
                   help="torch device (default the card)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    system, state, L = build(args.n_bodies, device=dev)

    gen = torch.Generator(device=dev).manual_seed(0)
    _, traj, auxs = integrators.simulate(
        system, state, gen, scheme="stochastic_Slip_Trapz", dt=5e-3,
        n_steps=args.n_steps, save_every=5)
    pos_t = traj.pos.double().cpu().numpy()      # (frames, B, 3)
    print(f"{args.n_bodies} bodies, {args.n_steps} steps: "
          f"det iters {sum(int(a.det_iterations) for a in auxs)}, "
          f"stoch iters {sum(int(a.stoch_iterations) for a in auxs)}, "
          f"rejections {sum(int(a.rejections) for a in auxs)}")
    if not np.all(np.isfinite(pos_t)):
        raise SystemExit("periodic_suspension_run: positions not finite")

    r, g_r, _ = gr.radial_distribution_pseudo2d(pos_t, L, L, n_bins=40)
    peak = r[np.argmax(g_r)]
    print(f"g(r): first peak at r = {peak:.2f} "
          f"(body spacing {SPACING:.2f})")


if __name__ == "__main__":
    main()
