"""Free-fiber relaxation with Brownian fluctuations on the PyTorch port:
the twin of examples/fibers/run.py. A stack of identical straight fibers
(length 2, --links links, a = ds/2, persistence length 4 times the
length) under per-fiber ("batched") hydrodynamics, semi-implicit bending
and the midpoint stochastic scheme with backward-Euler noise; the
end-to-end distance of every fiber is written at every save, one row a
save (the JAX script's layout).

Run:  python -m rigidmultiblobswall_tpu_torch.examples.fibers_run
          [--fibers 10] [--links 10] [--steps 200] [--save-every 20]
          [--kT 0.004142] [--output PATH] [--device cuda|cpu] [--f64]

The file goes to --output, or end_to_end_distances.txt in the working
directory. The run is on the card unless --device names another; float32
unless --f64; the noise comes from a torch.Generator seeded with 0.
"""

import argparse
import os

import numpy as np
import torch

from ..models import fibers as fib
from ..models.system import resolve_device

L_FIBER = 2.0


def build(n_fibers, n_links, kT, *, dtype=torch.float32, device=None):
    """The JAX script's scene: (suspension, state, dt). Fibers stacked at
    z = 0, 5a, 10a, ... along +y; dt = ds^3 / (m0 k_bend), the reference
    demo's alpha_fact = 1."""
    ds = L_FIBER / n_links
    a = ds / 2.0
    k_bend = 4.0 * L_FIBER * kT
    sus = fib.FiberSuspension(
        num_fibers=n_fibers, num_links=n_links, ds=ds, a=a, k_bend=k_bend,
        eta=1.0, kT=kT, impl_c=1.0, hydrodynamics="batched")
    x0 = np.zeros((n_fibers, 3))
    x0[:, 2] = 5.0 * a * np.arange(n_fibers)
    state = fib.straight_fiber_state(sus, x0, [0.0, 1.0, 0.0], dtype=dtype,
                                     device=device)
    dt = (ds ** 3 / sus.m0) / k_bend
    return sus, state, dt


def run(args, draws=None):
    """Simulate, write the end-to-end distances and print the JAX script's
    two lines; `draws` (FiberDraws, one a step) replaces the generator's.
    Returns the distances (n_saves, fibers) as float64 numpy."""
    dev = resolve_device(args.device)
    dtype = torch.float64 if args.f64 else torch.float32
    sus, state, dt = build(args.fibers, args.links, args.kT, dtype=dtype,
                           device=dev)
    print(f"fibers={args.fibers} blobs/fiber={sus.num_blobs_per_fiber} "
          f"dt={dt:.3e} kT={args.kT}")
    out = args.output or os.path.join(os.getcwd(), "end_to_end_distances.txt")
    gen = torch.Generator(device=dev).manual_seed(0)
    _, traj, _ = fib.simulate(sus, state, gen, dt=dt, n_steps=args.steps,
                              save_every=args.save_every, draws=draws)
    e2e = sus.ds * torch.linalg.norm(traj.t.sum(dim=2), dim=-1)
    e2e = e2e.double().cpu().numpy()
    np.savetxt(out, e2e)
    print(f"mean end-to-end {float(e2e[-1].mean()):.4f} "
          f"(contour {sus.ds * args.links:.4f}); wrote {out}")
    return e2e


def parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--fibers", type=int, default=10)
    p.add_argument("--links", type=int, default=10)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--save-every", type=int, default=20)
    p.add_argument("--kT", type=float, default=0.004142)
    p.add_argument("--output", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default the card)")
    p.add_argument("--f64", action="store_true", help="run in float64")
    return p


def main(argv=None):
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
