"""Time steppers of the PyTorch port against the JAX package, float64 on
the CPU: a few steps of each ported scheme from the same start, with
solver tolerance 1e-12, final positions and orientations agreeing to
1e-9. Stochastic steps feed the port's noise helper the normals the JAX
stepper draws from its key. Both packages take the materialized engine
at these sizes."""

import jax
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.models import integrators as jint
from rigidmultiblobswall_tpu_torch.models import integrators as tint

from torch_parity import (jax_zdft64, shells_scene, to_np,
                          wall_spectral_scene)
from torch_parity import feed_jax_noise as _feed_jax_noise

TOL = 1e-9


def _run_jax(js, jst, scheme, n_steps, dt, keys, update_PC=1):
    step = jax.jit(jint.make_stepper(js, scheme, dt, lanczos_tolerance=1e-10,
                                     update_PC=update_PC))
    carry = (jint.init_carry_with_pc(js, jst) if update_PC > 1
             else jint.init_carry(js, state=jst))
    s = jst
    for k in keys[:n_steps]:
        s, carry, aux = step(s, k, carry)
    return s, aux


def _run_port(ts, tst, scheme, n_steps, dt, update_PC=1):
    step = tint.make_stepper(ts, scheme, dt, lanczos_tolerance=1e-10,
                             update_PC=update_PC)
    carry = (tint.init_carry_with_pc(ts, tst) if update_PC > 1
             else tint.init_carry(ts, state=tst))
    gen = torch.Generator().manual_seed(0)
    s = tst
    for _ in range(n_steps):
        s, carry, aux = step(s, gen, carry)
    return s, aux


def _keys(n):
    return [jax.random.PRNGKey(100 + i) for i in range(n)]


@pytest.mark.parametrize("scheme", [
    "deterministic_forward_euler", "deterministic_adams_bashforth",
    "stochastic_Slip_Trapz", "deterministic_midpoint", "stochastic_EM",
    "stochastic_adams_bashforth", "deterministic_forward_euler_dense_algebra",
    "stochastic_first_order_RFD_dense_algebra", "Fixman",
    "stochastic_Slip_Mid_DLA"])
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


def _assert_same_final(jfinal, tfinal, jst):
    disp = np.abs(np.asarray(jfinal.pos) - np.asarray(jst.pos)).max()
    np.testing.assert_allclose(to_np(tfinal.pos), np.asarray(jfinal.pos),
                               atol=TOL * disp, rtol=0)
    np.testing.assert_allclose(to_np(tfinal.quat), np.asarray(jfinal.quat),
                               atol=TOL, rtol=0)


def test_slip_trapz_matches_jax_with_jax_noise(monkeypatch):
    """kT > 0: the port's draw_normal returns, in the port's draw order
    (W_slip, then the Lanczos z), the normals the JAX step draws."""
    js, jst, ts, tst, _, _ = shells_scene(3, seed=1, kT=0.05)
    keys = _keys(2)
    _feed_jax_noise(monkeypatch, keys, "stochastic_Slip_Trapz", js)
    jfinal, jaux = _run_jax(js, jst, "stochastic_Slip_Trapz", 2, 1e-3, keys)
    tfinal, taux = _run_port(ts, tst, "stochastic_Slip_Trapz", 2, 1e-3)
    assert int(jaux.rejections) == 0 and taux.rejections == 0
    _assert_same_final(jfinal, tfinal, jst)


@pytest.mark.parametrize("scheme", [
    "stochastic_EM", "stochastic_adams_bashforth",
    "stochastic_first_order_RFD_dense_algebra", "Fixman",
    "stochastic_Slip_Mid_DLA"])
def test_stochastic_scheme_matches_jax_with_jax_noise(monkeypatch, scheme):
    """kT > 0, two steps, the JAX step's normals fed to the port."""
    js, jst, ts, tst, _, _ = shells_scene(3, seed=3, kT=0.05)
    keys = _keys(2)
    _feed_jax_noise(monkeypatch, keys, scheme, js)
    jfinal, jaux = _run_jax(js, jst, scheme, 2, 1e-3, keys)
    tfinal, taux = _run_port(ts, tst, scheme, 2, 1e-3)
    assert int(jaux.rejections) == 0 and taux.rejections == 0
    assert taux.det_iterations == int(jaux.det_iterations)
    _assert_same_final(jfinal, tfinal, jst)


@pytest.mark.parametrize("scheme, kT", [("stochastic_Slip_Trapz", 0.05),
                                        ("deterministic_midpoint", 0.0)])
def test_update_pc_matches_jax(monkeypatch, scheme, kT):
    """update_PC = 2 over 3 steps: the preconditioner of step 0 serves
    step 1 and is refactored at step 2, in both packages."""
    js, jst, ts, tst, _, _ = shells_scene(3, seed=4, kT=kT)
    keys = _keys(3)
    if kT > 0:
        _feed_jax_noise(monkeypatch, keys, scheme, js)
    jfinal, jaux = _run_jax(js, jst, scheme, 3, 1e-3, keys, update_PC=2)
    tfinal, taux = _run_port(ts, tst, scheme, 3, 1e-3, update_PC=2)
    assert taux.det_iterations == int(jaux.det_iterations)
    _assert_same_final(jfinal, tfinal, jst)


def test_wall_spectral_slip_trapz_matches_jax_at_zero_temperature(
        monkeypatch):
    """single_wall_spectral: 3 Slip-Trapz steps of four six-blob shells on
    the wall engine (its plan carried and refreshed across steps; the
    wall-block preconditioner), kT = 0; the JAX wave side with float64
    z-DFT matrices."""
    from rigidmultiblobswall_tpu.ops import ewald_wall as jew

    monkeypatch.setattr(jew, "_host_zdft", jax_zdft64)
    js, jst, ts, tst = wall_spectral_scene()
    jfinal, jaux = _run_jax(js, jst, "stochastic_Slip_Trapz", 3, 2e-3,
                            _keys(3))
    tfinal, taux = _run_port(ts, tst, "stochastic_Slip_Trapz", 3, 2e-3)
    disp = np.abs(np.asarray(jfinal.pos) - np.asarray(jst.pos)).max()
    assert disp > 1e-4
    _assert_same_final(jfinal, tfinal, jst)
    assert taux.det_iterations == int(jaux.det_iterations)
    assert taux.capacity_overflows == int(jaux.capacity_overflows) == 0


def test_wall_rejection_retries_are_bounded():
    """A step that always crosses the wall retries max_rejections times
    and reports it, as the JAX stepper does."""
    _, _, ts, tst, _, _ = shells_scene(2, seed=2, g=1e4)
    step = tint.make_stepper(ts, "deterministic_forward_euler", 1.0,
                             max_rejections=3)
    _, _, aux = step(tst, torch.Generator(), tint.init_carry(ts, state=tst))
    assert aux.rejections == 2


def test_unported_schemes_and_options_raise():
    """Every scheme of the JAX package builds a stepper, the four
    articulated ones included (tests/test_torch_articulated.py and
    tests/test_torch_articulated_rollers.py run them); an unknown scheme
    raises, and Krylov recycling builds one."""
    _, _, ts, _, _, _ = shells_scene(2)
    assert set(jint.available_schemes()) == set(tint._SCHEMES)
    for scheme in jint.available_schemes():
        assert callable(tint.make_stepper(ts, scheme, 1e-3))
    with pytest.raises(ValueError):
        tint.make_stepper(ts, "no_such_scheme", 1e-3)
    assert callable(tint.make_stepper(ts, "stochastic_Slip_Trapz", 1e-3,
                                      recycle_k=4))
