"""The user hooks of the PyTorch port against the JAX package's, float64 on
the CPU: each System hook (blob_force_fn, body_force_torque_fn, slip_fn)
and all three together, and each roller hook (force_fn, torque_fn),
written once in jax.numpy for the JAX package and once in torch for the
port with the same physics, through both packages' make_stepper (equal
GMRES counts, positions within 1e-9 of the displacement); hooks enter
the force assembly and the right-hand side where the JAX package puts
them; from_reference refuses a JAX system or suspension that carries a
hook, pointing at the port's own fields."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.models import integrators as jint
from rigidmultiblobswall_tpu.models import kinematics as jkin
from rigidmultiblobswall_tpu.models import solvers as jsol
from rigidmultiblobswall_tpu_torch.models import integrators as tint
from rigidmultiblobswall_tpu_torch.models import kinematics as tkin
from rigidmultiblobswall_tpu_torch.models import rollers as trol
from rigidmultiblobswall_tpu_torch.models import solvers as tsol
from rigidmultiblobswall_tpu_torch.models import system as tsys

from test_torch_rollers import _positions, _run_both, _suspensions
from torch_parity import feed_jax_noise, shells_scene, to_np


def _stack(xp, cols):
    return (jnp.stack(cols, axis=1) if xp is jnp
            else torch.stack(cols, dim=1))


def _hooks(xp):
    """The three System hooks written on the array module xp (jax.numpy or
    torch): a blob force pulling toward x = 1, a body torque about z with a
    small lift, and a slip along x that grows with the height."""
    kin = jkin if xp is jnp else tkin

    def blob_force_fn(system, state, r):
        return _stack(xp, [0.3 * (1.0 - r[:, 0]), 0.1 * xp.sin(r[:, 1]),
                           0.0 * r[:, 2]])

    def body_force_torque_fn(system, state, r):
        z = state.pos[:, 2]
        zero = 0.0 * z
        return _stack(xp, [zero, zero, 0.05 * z, zero, zero, 0.4 + 0.1 * z])

    def slip_fn(system, state):
        r = kin.blob_positions(system, state)
        zero = 0.0 * r[:, 2]
        return _stack(xp, [0.2 * r[:, 2], zero, zero])

    return dict(blob_force_fn=blob_force_fn,
                body_force_torque_fn=body_force_torque_fn, slip_fn=slip_fn)


def _scene(names, kT=0.0):
    js, jst, ts, tst, pos, _ = shells_scene(4, seed=2, kT=kT,
                                            solver_tolerance=1e-10)
    jh = {k: v for k, v in _hooks(jnp).items() if k in names}
    th = {k: v for k, v in _hooks(torch).items() if k in names}
    return (dataclasses.replace(js, **jh), jst,
            dataclasses.replace(ts, **th), tst, pos)


def _steps(monkeypatch, names, scheme, kT=0.0, n_steps=3):
    js, jst, ts, tst, pos = _scene(names, kT)
    keys = [jax.random.PRNGKey(7 + i) for i in range(n_steps)]
    if kT > 0:
        feed_jax_noise(monkeypatch, keys, scheme, js)
    jstep = jax.jit(jint.make_stepper(js, scheme, 0.01))
    jc = jint.init_carry(js, state=jst)
    tstep = tint.make_stepper(ts, scheme, 0.01)
    tc = tint.init_carry(ts, state=tst)
    gen = torch.Generator().manual_seed(0)
    s, t = jst, tst
    for k in keys:
        s, jc, jaux = jstep(s, k, jc)
        t, tc, taux = tstep(t, gen, tc)
        assert taux.det_iterations == int(jaux.det_iterations)
        assert taux.rejections == int(jaux.rejections) == 0
    disp = np.abs(np.asarray(s.pos) - pos).max()
    assert disp > 1e-4
    np.testing.assert_allclose(to_np(t.pos), np.asarray(s.pos),
                               atol=1e-9 * disp, rtol=0)
    np.testing.assert_allclose(to_np(t.quat), np.asarray(s.quat),
                               atol=1e-9, rtol=0)
    return s


@pytest.mark.parametrize("hook", ["blob_force_fn", "body_force_torque_fn",
                                  "slip_fn"])
def test_system_hook_steps_match_jax(monkeypatch, hook):
    """One hook at a time, three deterministic Adams-Bashforth steps at
    kT = 0 (gravity off in the hook's own direction would leave nothing to
    compare; the scene's gravity and forces stay on)."""
    _steps(monkeypatch, (hook,), "deterministic_adams_bashforth")


def test_all_system_hooks_slip_trapz_match_jax(monkeypatch):
    """All three hooks under stochastic Slip-Trapz at kT = 0.05 with the
    JAX step's normals fed."""
    _steps(monkeypatch, ("blob_force_fn", "body_force_torque_fn", "slip_fn"),
           "stochastic_Slip_Trapz", kT=0.05)


def test_hooks_enter_forces_and_rhs_as_in_jax():
    names = ("blob_force_fn", "body_force_torque_fn", "slip_fn")
    js, jst, ts, tst, _ = _scene(names)
    jr, tr = jkin.blob_positions(js, jst), tkin.blob_positions(ts, tst)
    fj = np.asarray(jsol.force_torque_calculator(js, jst, jr))
    ft = to_np(tsol.force_torque_calculator(ts, tst, tr))
    assert np.abs(ft - fj).max() <= 1e-13 * np.abs(fj).max()
    base = dataclasses.replace(ts, blob_force_fn=None,
                               body_force_torque_fn=None, slip_fn=None)
    f0 = to_np(tsol.force_torque_calculator(base, tst, tr))
    assert np.abs(ft - f0).max() > 0.1
    rj = np.asarray(jsol.build_rhs(js, jst, jr))
    rt = to_np(tsol.build_rhs(ts, tst, tr))
    assert np.abs(rt - rj).max() <= 1e-13 * np.abs(rj).max()
    # an explicit slip replaces the hook's, as in the JAX package
    zero = torch.zeros((ts.num_blobs, 3), dtype=torch.float64)
    r0 = to_np(tsol.build_rhs(ts, tst, tr, slip=zero))
    assert not r0[:3 * ts.num_blobs].any()


def test_from_reference_refuses_jax_hooks():
    js, _, _, _, pos, quat = shells_scene(2)
    for name, fn in _hooks(jnp).items():
        with pytest.raises(NotImplementedError,
                           match=f"{name}.*JAX-traced.*own torch hook"):
            tsys.from_reference(dataclasses.replace(js, **{name: fn}), pos,
                                quat, device="cpu")


def _roller_hooks(xp):
    def force_fn(sus, r):
        return 0.2 * xp.cos(r)

    def torque_fn(sus, r):
        zero = 0.0 * r[:, 0]
        return _stack(xp, [zero, 0.5 + 0.1 * r[:, 2], zero])

    return dict(force_fn=force_fn, torque_fn=torque_fn)


@pytest.mark.parametrize("scheme", ["deterministic_forward_euler_rollers",
                                    "stochastic_adams_bashforth_rollers"])
@pytest.mark.parametrize("hook", ["force_fn", "torque_fn"])
def test_roller_hook_steps_match_jax(monkeypatch, hook, scheme):
    """A roller hook through both make_steppers with free kinematics (the
    torque hook prescribes the torques), the JAX normals fed."""
    jsus, tsus = _suspensions(free_kinematics=True, kT=0.05)
    jsus = dataclasses.replace(jsus, **{hook: _roller_hooks(jnp)[hook]})
    tsus = dataclasses.replace(tsus, **{hook: _roller_hooks(torch)[hook]})
    r0 = _positions(seed=3)
    jfinal, tfinal, iters = _run_both(jsus, tsus, scheme, r0, monkeypatch)
    disp = np.abs(jfinal - r0).max()
    assert disp > 1e-4
    np.testing.assert_allclose(tfinal, jfinal, atol=1e-9 * disp, rtol=0)
    for jit, tit in iters:
        assert tit == jit
    # the hook moved the rollers
    base = dataclasses.replace(jsus, **{hook: None})
    tbase = dataclasses.replace(tsus, **{hook: None})
    _, tfree, _ = _run_both(base, tbase, scheme, r0, monkeypatch)
    assert np.abs(tfree - tfinal).max() > 1e-6


def test_roller_hooks_in_forces_and_torques():
    _, tsus = _suspensions()
    tsus = dataclasses.replace(tsus, **_roller_hooks(torch))
    r = torch.as_tensor(_positions(seed=4))
    plain = dataclasses.replace(tsus, force_fn=None, torque_fn=None)
    df = trol.roller_forces(tsus, r) - trol.roller_forces(plain, r)
    assert torch.allclose(df, 0.2 * torch.cos(r), rtol=0, atol=1e-15)
    t = trol.roller_torques(tsus, r)
    assert t.shape == (tsus.num_rollers, 3)
    assert not trol.roller_torques(plain, r).any()
    assert torch.allclose(t[:, 1], 0.5 + 0.1 * r[:, 2])
