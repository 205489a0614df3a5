"""Shared helpers for the parity tests of the PyTorch port
(tests/test_torch_*.py): small scenes made from a numpy seed, built both
as JAX-package objects and as the port's objects, in float64 on the CPU.
"""

import numpy as np
import torch

from rigidmultiblobswall_tpu.models import system as jsys
from rigidmultiblobswall_tpu_torch.models import system as tsys

torch.set_num_threads(1)


def shell_vertices(n=12, radius=0.5):
    """Fibonacci shell of n blobs (bench.py's multibody body)."""
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return radius * np.stack([np.cos(theta) * np.sin(phi),
                              np.sin(theta) * np.sin(phi),
                              np.cos(phi)], axis=1)


def random_blobs(n=37, seed=7, a=0.3):
    """Blob positions including blobs below a (overlap-regularized) and
    well above the wall, plus a random vector field."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0, 5, (n, 3))
    r[:, 2] = rng.uniform(0.05, 4, n)
    return r, rng.normal(size=(n, 3))


def shells_scene(n_bodies=3, seed=0, nb=12, **overrides):
    """A few 12-blob shells above the wall with bench.py's multibody
    physics at a small size. Returns (jax_system, jax_state,
    port_system, port_state, pos, quat)."""
    rng = np.random.default_rng(seed)
    pos = np.stack([1.6 * np.arange(n_bodies), 0.4 * np.arange(n_bodies),
                    np.full(n_bodies, 0.9)], axis=1)
    pos[:, :2] += rng.uniform(-0.2, 0.2, (n_bodies, 2))
    quat = rng.normal(size=(n_bodies, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    kw = dict(eta=1.0, blob_radius=0.131, kT=0.0, g=0.1,
              domain="single_wall", repulsion_strength_wall=0.2,
              debye_length_wall=0.2, repulsion_strength=0.2,
              debye_length=0.2, solver_tolerance=1e-12)
    kw.update(overrides)
    jt = jsys.BodyType(name="shell12", ref_config=shell_vertices(nb, 0.5),
                       count=n_bodies)
    jsystem = jsys.System(types=(jt,), **kw)
    jstate = jsys.make_state(pos, quat)
    tsystem, tstate = tsys.from_reference(jsystem, pos, quat, device="cpu")
    return jsystem, jstate, tsystem, tstate, pos, quat


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rel_err(got, ref):
    got, ref = to_np(got), to_np(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())
