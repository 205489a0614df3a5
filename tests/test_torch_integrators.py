"""Time steppers of the PyTorch port against the JAX package, float64 on
the CPU: a few steps of each ported scheme from the same start, with
solver tolerance 1e-12, final positions and orientations agreeing to
1e-9. Stochastic steps feed the port's noise helper the normals the JAX
stepper draws from its key."""

import jax
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.models import integrators as jint
from rigidmultiblobswall_tpu_torch.models import integrators as tint

from torch_parity import shells_scene, to_np

TOL = 1e-9


def _run_jax(js, jst, scheme, n_steps, dt, keys):
    step = jax.jit(jint.make_stepper(js, scheme, dt, lanczos_tolerance=1e-10))
    carry = jint.init_carry(js, state=jst)
    s = jst
    for k in keys[:n_steps]:
        s, carry, aux = step(s, k, carry)
    return s, aux


def _run_port(ts, tst, scheme, n_steps, dt):
    step = tint.make_stepper(ts, scheme, dt, lanczos_tolerance=1e-10)
    carry = tint.init_carry(ts, state=tst)
    gen = torch.Generator().manual_seed(0)
    s = tst
    for _ in range(n_steps):
        s, carry, aux = step(s, gen, carry)
    return s, aux


def _keys(n):
    return [jax.random.PRNGKey(100 + i) for i in range(n)]


@pytest.mark.parametrize("scheme", ["deterministic_forward_euler",
                                    "deterministic_adams_bashforth",
                                    "stochastic_Slip_Trapz"])
def test_scheme_matches_jax_at_zero_temperature(scheme):
    js, jst, ts, tst, _, _ = shells_scene(3, seed=0)
    jfinal, jaux = _run_jax(js, jst, scheme, 3, 2e-3, _keys(3))
    tfinal, taux = _run_port(ts, tst, scheme, 3, 2e-3)
    disp = np.abs(np.asarray(jfinal.pos) - np.asarray(jst.pos)).max()
    assert disp > 1e-4  # the bodies really moved
    np.testing.assert_allclose(to_np(tfinal.pos), np.asarray(jfinal.pos),
                               atol=TOL * disp, rtol=0)
    np.testing.assert_allclose(to_np(tfinal.quat), np.asarray(jfinal.quat),
                               atol=TOL, rtol=0)
    assert taux.det_iterations == int(jaux.det_iterations)
    assert taux.stoch_iterations == int(jaux.stoch_iterations)
    assert taux.rejections == 0 and taux.solves_converged


def test_slip_trapz_matches_jax_with_jax_noise(monkeypatch):
    """kT > 0: the port's draw_normal returns, in the port's draw order
    (W_slip, then the Lanczos z), the normals the JAX step draws."""
    js, jst, ts, tst, _, _ = shells_scene(3, seed=1, kT=0.05)
    keys = _keys(2)
    n = js.num_blobs
    draws = []
    for key in keys:
        _, sub = jax.random.split(key)       # make_stepper's attempt key
        k1, k2 = jax.random.split(sub)       # Slip-Trapz's noise keys
        draws.append(np.array(jax.random.normal(k2, (n, 3))))
        draws.append(np.array(jax.random.normal(k1, (3 * n,))))
    feed = iter(draws)

    def jax_draws(generator, shape, like):
        z = next(feed)
        assert z.shape == tuple(shape)
        return torch.as_tensor(z, dtype=like.dtype, device=like.device)

    monkeypatch.setattr(tint, "draw_normal", jax_draws)
    jfinal, jaux = _run_jax(js, jst, "stochastic_Slip_Trapz", 2, 1e-3, keys)
    tfinal, taux = _run_port(ts, tst, "stochastic_Slip_Trapz", 2, 1e-3)
    assert int(jaux.rejections) == 0 and taux.rejections == 0
    disp = np.abs(np.asarray(jfinal.pos) - np.asarray(jst.pos)).max()
    np.testing.assert_allclose(to_np(tfinal.pos), np.asarray(jfinal.pos),
                               atol=TOL * disp, rtol=0)
    np.testing.assert_allclose(to_np(tfinal.quat), np.asarray(jfinal.quat),
                               atol=TOL, rtol=0)


def test_wall_rejection_retries_are_bounded():
    """A step that always crosses the wall retries max_rejections times
    and reports it, as the JAX stepper does."""
    _, _, ts, tst, _, _ = shells_scene(2, seed=2, g=1e4)
    step = tint.make_stepper(ts, "deterministic_forward_euler", 1.0,
                             max_rejections=3)
    _, _, aux = step(tst, torch.Generator(), tint.init_carry(ts, state=tst))
    assert aux.rejections == 2


def test_unported_schemes_and_options_raise():
    _, _, ts, _, _, _ = shells_scene(2)
    with pytest.raises(NotImplementedError):
        tint.make_stepper(ts, "stochastic_EM", 1e-3)
    with pytest.raises(ValueError):
        tint.make_stepper(ts, "no_such_scheme", 1e-3)
    with pytest.raises(NotImplementedError):
        tint.make_stepper(ts, "stochastic_Slip_Trapz", 1e-3, update_PC=5)
