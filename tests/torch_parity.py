"""Shared helpers for the parity tests of the PyTorch port
(tests/test_torch_*.py): small scenes made from a numpy seed, built both
as JAX-package objects and as the port's objects, in float64 on the CPU.
"""

import functools

import numpy as np
import torch

from rigidmultiblobswall_tpu.models import system as jsys
from rigidmultiblobswall_tpu.ops import ewald_wall as jew
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


def wall_spectral_scene(kT=0.0, a=0.25, eta=0.9, box=6.5):
    """Four six-blob shells above the wall in a 26 a box on the spectral
    wall engine, tolerance 1e-3 (the Brownian-step scene of
    tests/test_wall_spectral.py). Returns (jax_system, jax_state,
    port_system, port_state)."""
    rng = np.random.default_rng(6)
    shell = rng.normal(size=(6, 3))
    shell *= 0.5 * a / np.linalg.norm(shell, axis=1, keepdims=True)
    t = jsys.BodyType(name="s6", ref_config=shell, count=4)
    js = jsys.System(types=(t,), eta=eta, blob_radius=a, kT=kT, g=0.3,
                     domain="single_wall_spectral",
                     periodic_length=(box, box, 0.0),
                     spectral_wall_height=5.0 * a, spectral_tol=1e-3,
                     repulsion_strength_wall=0.2, debye_length_wall=0.3,
                     solver_tolerance=1e-12)
    pos = np.stack([rng.uniform(2 * a, box - 2 * a, 4),
                    rng.uniform(2 * a, box - 2 * a, 4),
                    rng.uniform(1.8 * a, 3.0 * a, 4)], axis=1)
    quat = np.tile([1.0, 0, 0, 0], (4, 1))
    ts, tst = tsys.from_reference(js, pos, quat, device="cpu")
    return js, jsys.make_state(pos, quat), ts, tst


@functools.lru_cache(maxsize=16)
def jax_zdft64(params):
    """The JAX wall engine's _host_zdft with float64 matrices: the JAX
    package stores them in float32 (a TPU runtime limit), which caps its
    float64 wave side near 1e-8; parity tests patch this in."""
    gz = params.grid[2]
    (da, db), (ia, ib), (ra, rb) = jew._z_plane_ranges(params)
    kz = np.arange(gz)

    def fwd(lo, hi):
        m = np.exp(-2j * np.pi * np.outer(np.arange(lo, hi), kz) / gz)
        return m.real, m.imag

    wi = np.exp(2j * np.pi * np.outer(kz, np.arange(ra, rb)) / gz) / gz
    return fwd(da, db), fwd(ia, ib), (wi.real, wi.imag)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rel_err(got, ref):
    got, ref = to_np(got), to_np(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def jax_normals(key, scheme, js):
    """The normals a JAX attempt of `scheme` on a pairwise domain draws
    from its step key, in the order the port's scheme asks draw_normal
    for them."""
    import jax

    _, sub = jax.random.split(key)           # make_stepper's attempt key
    n3, b6 = 3 * js.num_blobs, (js.num_bodies, 6)
    if scheme == "stochastic_Slip_Trapz":
        k1, k2 = jax.random.split(sub)
        return [(k2, (js.num_blobs, 3)), (k1, (n3,))]
    if scheme == "stochastic_EM":
        return [(sub, (n3,))]
    if scheme in ("stochastic_adams_bashforth", "stochastic_first_order_RFD"):
        k_noise, k_rfd = jax.random.split(sub)
        return [(k_noise, (n3,)), (k_rfd, b6)]
    if scheme == "stochastic_traction_EM":
        k_noise, k_rfd = jax.random.split(sub)
        return [(k_rfd, (js.num_blobs, 3)), (k_noise, (n3,))]
    if scheme == "stochastic_traction_AB":
        k_rfd, k_noise = jax.random.split(sub)
        return [(k_rfd, b6), (k_noise, (n3,))]
    if scheme == "stochastic_GDC_RFD":
        # the midpoint noise takes z's key again: the same z, not a draw
        k_w, k_rfd = jax.random.split(sub)
        return [(k_w, (n3,)), (k_rfd, b6)]
    if scheme == "stochastic_Slip_Mid":
        k1, k2, k3 = jax.random.split(sub, 3)
        return [(k2, (js.num_blobs, 3)), (k1, (n3,)), (k3, (n3,))]
    if scheme == "stochastic_first_order_RFD_dense_algebra":
        k_noise, k_rfd = jax.random.split(sub)
        return [(k_noise, (6 * js.num_bodies,)), (k_rfd, b6)]
    if scheme == "Fixman":
        k1, k2 = jax.random.split(sub)
        return [(k1, (6 * js.num_bodies,)), (k2, (6 * js.num_bodies,))]
    assert scheme == "stochastic_Slip_Mid_DLA"
    return [(k, (n3,)) for k in jax.random.split(sub, 3)]


def feed_jax_noise(monkeypatch, keys, scheme, js):
    """Make the port's integrators.draw_normal return, in order, the
    normals the JAX steps of `keys` draw (jax_normals); a draw the JAX
    step does not make, or one of another shape, fails."""
    import jax

    from rigidmultiblobswall_tpu_torch.models import integrators as tint

    draws = [np.array(jax.random.normal(k, shape))
             for key in keys for k, shape in jax_normals(key, scheme, js)]
    feed = iter(draws)

    def jax_draws(generator, shape, like):
        z = next(feed)
        assert z.shape == tuple(shape)
        return torch.as_tensor(z, dtype=like.dtype, device=like.device)

    monkeypatch.setattr(tint, "draw_normal", jax_draws)
