"""The PyTorch port's MCMC sampler (models/mcmc.py) and its pair energy
(ops/forces.blob_blob_energy, the plain version of kernel M1) against the
JAX package, float64 on the CPU: the energies on random scenes (open,
wall, periodic, blobs below the wall, coincident blobs) to 1e-12, the
chunked plain version against an unchunked one, one Metropolis step and
20 burn-in + chain steps on JAX's own draws fed, the save cadence, the
adaptive burn-in, the rejection sampler on fed draws, and JAX
tests/test_mcmc.py's statistical checks on torch draws."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.models import mcmc as jmcmc
from rigidmultiblobswall_tpu.models import system as jsys
from rigidmultiblobswall_tpu.ops import forces as jforces
from rigidmultiblobswall_tpu.ops import quaternion as jquat
from rigidmultiblobswall_tpu_torch.models import kinematics as tkin
from rigidmultiblobswall_tpu_torch.models import mcmc as tmcmc
from rigidmultiblobswall_tpu_torch.models import system as tsys
from rigidmultiblobswall_tpu_torch.ops import forces as tforces
from rigidmultiblobswall_tpu_torch.ops import mobility_cuda as tmc

from torch_parity import random_blobs, shell_vertices, to_np

PHYS = dict(blob_radius=0.2, kT=0.3, g=0.5, repulsion_strength_wall=0.4,
            debye_length_wall=0.3, repulsion_strength=0.7, debye_length=0.25)
L_BOX = 4.0
# (domain, periodic_length) of each scene: open, above the wall, the wall
# slab periodic in x and y, and a fully periodic box
DOMAINS = {"open": ("no_wall", (0.0, 0.0, 0.0)),
           "wall": ("single_wall", (0.0, 0.0, 0.0)),
           "wall_xy_periodic": ("single_wall_spectral", (L_BOX, L_BOX, 0.0)),
           "periodic": ("periodic_spectral", (L_BOX, L_BOX, L_BOX))}


def _scene(domain, n_bodies=5, seed=0, coincident=True, **overrides):
    """Shells of 12 blobs (radius 0.5) with a second type of 3-blob rods,
    some blobs below the wall, and (coincident) body 1 on body 0 with the
    same orientation, so every blob of one coincides with one of the
    other. Returns (jax system, jax state, port system, port state)."""
    dom, box = DOMAINS[domain]
    rng = np.random.default_rng(seed)
    rod = np.array([[-0.3, 0, 0], [0, 0, 0], [0.3, 0, 0]])
    types = ((shell_vertices(12, 0.5), n_bodies), (rod, 2))
    jtypes = tuple(jsys.BodyType(name=f"t{k}", ref_config=ref, count=c)
                   for k, (ref, c) in enumerate(types))
    B = n_bodies + 2
    pos = np.stack([rng.uniform(-1, 5, B), rng.uniform(-1, 5, B),
                    rng.uniform(-0.2, 2.5, B)], axis=1)
    quat = rng.normal(size=(B, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    if coincident:
        pos[1], quat[1] = pos[0], quat[0]
    kw = dict(PHYS, domain=dom, periodic_length=box)
    if dom == "single_wall_spectral":
        kw["spectral_wall_height"] = 4.0
    kw.update(overrides)
    js = jsys.System(types=jtypes, **kw)
    ts, tst = tsys.from_reference(js, pos, quat, device="cpu")
    return js, jsys.make_state(pos, quat), ts, tst


@pytest.mark.parametrize("domain", list(DOMAINS))
def test_total_energy_matches_jax(domain):
    js, jst, ts, tst = _scene(domain)
    ref = float(jmcmc.total_energy(js, jst))
    got = tmcmc.total_energy(ts, tst)
    assert got.dtype == torch.float64 and got.shape == ()
    assert abs(float(got) - ref) <= 1e-12 * abs(ref)
    # some blobs lie below the wall and take the penalty
    assert float(tkin.blob_positions(ts, tst)[:, 2].min()) < 0.0


@pytest.mark.parametrize("domain", list(DOMAINS))
@pytest.mark.parametrize("coincident", [False, True])
def test_pair_energy_matches_jax(domain, coincident):
    """blob_blob_energy (coincident pairs dropped) against JAX's, and the
    total_energy flavour (a coincident pair at r = 1) against the pair
    term of JAX's total_energy (the JAX total less its one-body part)."""
    _, box = DOMAINS[domain]
    r, _ = random_blobs(n=43, seed=3)
    if coincident:
        r[7] = r[6]
    kw = dict(repulsion_strength=0.7, debye_length=0.25, blob_radius=0.2,
              periodic_length=box)
    ref = float(jforces.blob_blob_energy(jnp.asarray(r), **kw))
    got = tforces.blob_blob_energy(torch.as_tensor(r), **kw)
    assert got.dtype == torch.float64 and got.shape == ()
    assert abs(float(got) - ref) <= 1e-12 * abs(ref)
    one = float(tforces.blob_blob_energy(torch.as_tensor(r), **kw,
                                         coincident="one"))
    # one pair at r = 1: eps (1 + (2a - 1)/b) or eps exp(-(1 - 2a)/b)
    extra = 0.7 * np.exp(-(1.0 - 0.4) / 0.25) if coincident else 0.0
    assert abs(one - (ref + extra)) <= 1e-12 * abs(ref)


def test_coincident_flavours_follow_each_jax_function():
    """A scene of one body of two coincident blobs: JAX's blob_blob_energy
    drops the pair, its total_energy counts it at r = 1; so do the port's."""
    js = jsys.System(types=(jsys.BodyType(name="d", ref_config=np.zeros(
        (2, 3)), count=1),), domain="single_wall", **PHYS)
    ts, tst = tsys.from_reference(js, [[0, 0, 1.0]], [[1, 0, 0, 0]],
                                  device="cpu")
    jst = jsys.make_state([[0, 0, 1.0]], [[1, 0, 0, 0]])
    r = np.zeros((2, 3)) + [0, 0, 1.0]
    kw = dict(repulsion_strength=0.7, debye_length=0.25, blob_radius=0.2)
    assert float(jforces.blob_blob_energy(jnp.asarray(r), **kw)) == 0.0
    assert float(tforces.blob_blob_energy(torch.as_tensor(r), **kw)) == 0.0
    ref = float(jmcmc.total_energy(js, jst))
    got = float(tmcmc.total_energy(ts, tst))
    one_body = 2 * (0.5 * 1.0 + 0.4 * np.exp(-(1.0 - 0.2) / 0.3))
    assert abs(ref - one_body - 0.7 * np.exp(-(1.0 - 0.4) / 0.25)) < 1e-12
    assert abs(got - ref) <= 1e-12 * abs(ref)


@pytest.mark.parametrize("coincident", ["zero", "one"])
@pytest.mark.parametrize("box", [(0.0, 0.0, 0.0), (3.0, 3.0, 0.0)])
def test_chunked_plain_energy_matches_unchunked(coincident, box,
                                                monkeypatch):
    """The plain version's chunks (3 or 7 target rows of one configuration
    at a time, or 2 configurations a chunk) against one unchunked pass,
    on a batch of 4 configurations with a coincident pair."""
    rng = np.random.default_rng(5)
    r = rng.uniform(0, 4, (4, 50, 3))
    r[:, 9] = r[:, 8]
    rt = torch.as_tensor(r)
    kw = dict(repulsion_strength=0.7, debye_length=0.25, blob_radius=0.2,
              periodic_length=box, coincident=coincident)
    assert tmc._energy_rows(50, 4) == (4, 50)
    assert tmc._energy_rows(49152, 1) == (1, 113)
    monkeypatch.setattr(tmc, "_energy_rows", lambda n, n_conf: (1, n))
    whole = tmc.blob_blob_energy_plain(rt, **kw)
    for chunk in ((1, 3), (1, 7), (2, 50)):
        monkeypatch.setattr(tmc, "_energy_rows",
                            lambda n, n_conf, chunk=chunk: chunk)
        got = tmc.blob_blob_energy_plain(rt, **kw)
        assert torch.allclose(got, whole, rtol=1e-13, atol=0)
    # the wrapper on a CPU tensor is the plain version
    assert torch.allclose(tmc.blob_pair_energy(rt, **kw), whole, rtol=1e-13,
                          atol=0)
    with pytest.raises(ValueError, match="coincident"):
        tmc.blob_blob_energy_plain(rt, **dict(kw, coincident="half"))


def _jax_step_draws(key, n_bodies):
    """The draws of JAX's make_mcmc_kernel step of `key`."""
    k_trans, k_rot, k_accept = jax.random.split(key, 3)
    dx = jax.random.uniform(k_trans, (n_bodies, 3), dtype=jnp.float64,
                            minval=-1.0, maxval=1.0)
    dphi = jax.random.normal(k_rot, (n_bodies, 3), dtype=jnp.float64)
    u = jax.random.uniform(k_accept, (), dtype=jnp.float64)
    return tmcmc.Draws(*(torch.as_tensor(np.array(x)) for x in (dx, dphi,
                                                                u)))


def _jax_chain_keys(key, n_steps, save_every, initial_step):
    """The keys of JAX's run_mcmc moves, in move order (burn-in first)."""
    key, k_burn = jax.random.split(key)
    keys = []
    if initial_step < 0:
        keys += list(jax.random.split(k_burn, -initial_step))
    k_first, k_blocks, k_tail = jax.random.split(key, 3)
    keys.append(k_first)
    for kb in jax.random.split(k_blocks, max(n_steps - 1, 0) // save_every):
        keys += list(jax.random.split(kb, save_every))
    n_tail = max(n_steps - 1, 0) % save_every
    if n_tail:
        keys += list(jax.random.split(k_tail, n_tail))
    return keys


def _assert_states_close(got, ref, tol=1e-10):
    for g, r in ((got.pos, ref.pos), (got.quat, ref.quat)):
        np.testing.assert_allclose(to_np(g), np.asarray(r), rtol=0,
                                   atol=tol * max(np.abs(np.asarray(r)).max(),
                                                  1.0))


@pytest.mark.parametrize("domain", ["wall", "wall_xy_periodic"])
def test_one_step_matches_jax(domain):
    """One Metropolis step from init_mcmc on the draws of one JAX key, with
    a prescribed (frozen) body type: same proposal, energy, accept, ratio
    and d; the step is taken twice, accepted and rejected."""
    js, jst, ts, tst = _scene(domain, coincident=False)
    jk = jmcmc.make_mcmc_kernel(js)
    tk = tmcmc.make_mcmc_kernel(ts)
    seen = set()
    for seed in range(12):
        key = jax.random.PRNGKey(seed)
        j1 = jk(jmcmc.init_mcmc(js, jst), key, True)
        t1 = tk(tmcmc.init_mcmc(ts, tst), adapt=True,
                draws=_jax_step_draws(key, ts.num_bodies))
        _assert_states_close(t1.state, j1.state)
        assert abs(float(t1.energy) - float(j1.energy)) <= 1e-12 * abs(
            float(j1.energy))
        assert int(t1.accepted) == int(j1.accepted)
        for f in ("max_translation", "acc_ratio"):
            assert abs(float(getattr(t1, f)) - float(getattr(j1, f))) < 1e-15
        seen.add(int(t1.accepted))
    assert seen == {0, 1}


def test_prescribed_bodies_stay():
    """A body type with prescribed kinematics is never moved."""
    js, jst, ts, tst = _scene("wall", coincident=False)
    types = (ts.types[0], dataclasses.replace(ts.types[1],
                                              prescribed_kinematics=True))
    ts = dataclasses.replace(ts, types=types, kT=1e3)
    mc, _, _ = tmcmc.run_mcmc(ts, tst, torch.Generator().manual_seed(0),
                              n_steps=5)
    assert int(mc.accepted) > 0
    assert torch.equal(mc.state.pos[-2:], tst.pos[-2:])
    assert torch.equal(mc.state.quat[-2:], tst.quat[-2:])
    assert not torch.equal(mc.state.pos[:-2], tst.pos[:-2])


@pytest.mark.parametrize("domain", ["wall", "periodic"])
def test_burn_in_and_chain_match_jax(domain):
    """20 burn-in steps (the first 10 adapting d) then a 20-step chain saved
    every 3 (7 frames, a 1-move tail), on JAX's draws of the same key."""
    js, jst, ts, tst = _scene(domain, coincident=False)
    key = jax.random.PRNGKey(4)
    kw = dict(n_steps=20, save_every=3, initial_step=-20)
    jmc, jtraj, jen = jmcmc.run_mcmc(js, jst, key, **kw)
    draws = [_jax_step_draws(k, ts.num_bodies)
             for k in _jax_chain_keys(key, **kw)]
    assert len(draws) == 40
    tmc_, ttraj, ten = tmcmc.run_mcmc(ts, tst, draws=draws, **kw)
    assert ttraj.pos.shape == np.asarray(jtraj.pos).shape == (7, 7, 3)
    _assert_states_close(ttraj, jtraj)
    _assert_states_close(tmc_.state, jmc.state)
    np.testing.assert_allclose(to_np(ten), np.asarray(jen), rtol=1e-12,
                               atol=0)
    assert int(tmc_.accepted) == int(jmc.accepted)
    assert 0 < int(jmc.accepted) < 40
    assert abs(float(tmc_.max_translation)
               - float(jmc.max_translation)) < 1e-15
    assert float(jmc.max_translation) != 0.1 * js.blob_radius


@pytest.mark.parametrize("n_steps", [1, 7, 40])
@pytest.mark.parametrize("save_every", [1, 3, 10])
def test_save_cadence(n_steps, save_every):
    """Frame s is the state after s save_every + 1 moves, and all n_steps
    moves run (the final state is after the last), as in JAX: the frame
    count is JAX's, and each frame equals a step-by-step chain's state on
    the same draws."""
    js, jst, ts, tst = _scene("wall", n_bodies=2, coincident=False)
    gen = torch.Generator().manual_seed(n_steps * 100 + save_every)
    draws = [tmcmc.draw(ts, gen, torch.float64, "cpu")
             for _ in range(n_steps)]
    mc, traj, energies = tmcmc.run_mcmc(ts, tst, draws=draws,
                                        n_steps=n_steps,
                                        save_every=save_every)
    _, jtraj, _ = jmcmc.run_mcmc(js, jst, jax.random.PRNGKey(0),
                                 n_steps=n_steps, save_every=save_every)
    n_frames = np.asarray(jtraj.pos).shape[0]
    assert traj.pos.shape[0] == energies.shape[0] == n_frames
    assert n_frames == (n_steps - 1) // save_every + 1
    kernel = tmcmc.make_mcmc_kernel(ts)
    step = tmcmc.init_mcmc(ts, tst)
    after = []
    for d in draws:
        step = kernel(step, draws=d)
        after.append(step)
    for s in range(n_frames):
        ref = after[s * save_every]
        assert torch.equal(traj.pos[s], ref.state.pos)
        assert torch.equal(energies[s], ref.energy)
    assert torch.equal(mc.state.pos, after[-1].state.pos)
    assert int(mc.accepted) == int(after[-1].accepted)


def test_no_steps_returns_empty_trajectory():
    js, jst, ts, tst = _scene("wall", n_bodies=2, coincident=False)
    mc, traj, energies = tmcmc.run_mcmc(ts, tst, torch.Generator(),
                                        n_steps=0)
    assert traj.pos.shape == (0, 4, 3) and energies.shape == (0,)
    assert torch.equal(mc.state.pos, tst.pos)


def test_adaptive_burn_in_matches_jax_rule():
    """The burn-in's d on the port's own draws: d <- d 1.02 when the EWMA
    ratio exceeds 0.5, else d 0.98, over the first half only (JAX's
    flags), recomputed here from the accepts of a step-by-step run."""
    js, jst, ts, tst = _scene("wall", n_bodies=2, coincident=False)
    gen = torch.Generator().manual_seed(9)
    draws = [tmcmc.draw(ts, gen, torch.float64, "cpu") for _ in range(31)]
    mc, _, _ = tmcmc.run_mcmc(ts, tst, draws=draws, n_steps=1,
                              initial_step=-30)
    flags = np.arange(-30, 0) < (-30 // 2)
    assert flags.sum() == 15
    kernel = tmcmc.make_mcmc_kernel(ts)
    step = tmcmc.init_mcmc(ts, tst)
    d, ratio = 0.1 * ts.blob_radius, 0.5
    for k in range(31):
        acc = int(step.accepted)
        step = kernel(step, draws=draws[k], adapt=k < 30 and bool(flags[k]))
        ratio = 0.95 * ratio + 0.05 * (int(step.accepted) - acc)
        if k < 30 and flags[k]:
            d = d * 1.02 if ratio > 0.5 else d * 0.98
    assert abs(float(mc.max_translation) - d) < 1e-15
    assert abs(d - 0.1 * ts.blob_radius) > 1e-6


def _jax_rejection_draws(js, key, n_steps, n_estimate):
    """The proposals and uniform draws of JAX's run_rejection_sampler."""
    box = 5.0 * jmcmc._max_body_length(js)
    B = js.num_bodies

    def propose(k):
        k1, k2 = jax.random.split(k)
        return (jax.random.uniform(k1, (B, 3), dtype=jnp.float64, minval=0.0,
                                   maxval=box),
                jquat.random(k2, (B,), dtype=jnp.float64))

    key, k_est = jax.random.split(key)
    est = jax.vmap(propose)(jax.random.split(k_est, n_estimate))

    def sample(k):
        k_prop, k_acc = jax.random.split(k)
        return propose(k_prop) + (jax.random.uniform(k_acc, (),
                                                      dtype=jnp.float64),)

    pos, q, u = jax.vmap(sample)(jax.random.split(key, n_steps))
    t = lambda x: torch.as_tensor(np.array(x))  # noqa: E731
    return tmcmc.RejectionDraws(t(est[0]), t(est[1]), t(pos), t(q), t(u))


@pytest.mark.parametrize("batch", [7, 4096])
def test_rejection_sampler_matches_jax(batch, monkeypatch):
    """The rejection sampler on JAX's proposals and draws fed, evaluated
    `batch` at a time (REJECTION_BATCH, and 7, which leaves ragged
    batches): the same minimum energy, energies and accepted set."""
    monkeypatch.setattr(tmcmc, "REJECTION_BATCH", batch)
    js = jsys.System(types=(jsys.BodyType(
        name="s", ref_config=shell_vertices(12, 0.5), count=2),),
        domain="single_wall", **dict(PHYS, kT=2.0))
    ts = tsys.from_reference(js)
    key = jax.random.PRNGKey(3)
    res = jmcmc.run_rejection_sampler(js, key, n_steps=60, n_estimate=50)
    got = tmcmc.run_rejection_sampler(
        ts, n_steps=60, n_estimate=50, device="cpu",
        draws=_jax_rejection_draws(js, key, 60, 50))
    ref_min = float(res.minimum_energy)
    assert abs(float(got.minimum_energy) - ref_min) <= 1e-12 * abs(ref_min)
    np.testing.assert_allclose(to_np(got.energies), np.asarray(res.energies),
                               rtol=1e-12, atol=0)
    acc = np.asarray(res.accepted)
    assert 0 < acc.sum() < 60
    np.testing.assert_array_equal(to_np(got.accepted), acc)
    np.testing.assert_allclose(to_np(got.states.pos),
                               np.asarray(res.states.pos), rtol=0, atol=0)


# JAX tests/test_mcmc.py's checks, on torch draws


def _single_blob_system(kT=0.5, g=2.0):
    t = tsys.BodyType(name="b", ref_config=np.zeros((1, 3)), count=1)
    return tsys.System(types=(t,), blob_radius=0.25, kT=kT, g=g,
                       repulsion_strength_wall=1.0, debye_length_wall=0.25,
                       repulsion_strength=0.0, domain="single_wall")


def _state(z):
    return tsys.make_state([[0, 0, z]], [[1, 0, 0, 0]], device="cpu")


def test_energy_components():
    system = _single_blob_system()
    e = float(tmcmc.total_energy(system, _state(2.0)))
    expected = 2.0 * 2.0 + 1.0 * np.exp(-(2.0 - 0.25) / 0.25)
    assert np.isclose(e, expected, rtol=1e-12)
    assert float(tmcmc.total_energy(system, _state(-0.5))) > 1e4


def test_mcmc_chain_acceptance_and_validity():
    system = _single_blob_system()
    mc, traj, energies = tmcmc.run_mcmc(
        system, _state(1.0), torch.Generator().manual_seed(0), n_steps=400,
        save_every=10)
    acc = int(mc.accepted) / 400
    assert 0.05 < acc < 1.0
    assert bool(torch.isfinite(energies).all())
    assert bool((traj.pos[:, 0, 2] > 0).all())


def test_mcmc_save_cadence_matches_reference():
    system = _single_blob_system()
    mc, traj, energies = tmcmc.run_mcmc(
        system, _state(1.0), torch.Generator().manual_seed(3), n_steps=105,
        save_every=10)
    assert energies.shape[0] == traj.pos.shape[0] == 11
    assert 0 <= int(mc.accepted) <= 105


def test_mcmc_gibbs_boltzmann_height_distribution():
    """The chain's mean height of a blob under gravity and the wall
    repulsion against the Gibbs-Boltzmann average of exp(-U(z)/kT)."""
    system = _single_blob_system(kT=0.5, g=2.0)
    _, traj, _ = tmcmc.run_mcmc(system, _state(0.6),
                                torch.Generator().manual_seed(1),
                                n_steps=10000, save_every=10,
                                max_translation=0.3)
    z = to_np(traj.pos)[:, 0, 2]
    z = z[len(z) // 5:]
    zg = np.linspace(1e-4, 6, 4000)
    a, b, eps, g, kT = 0.25, 0.25, 1.0, 2.0, 0.5
    U = g * zg + np.where(zg < a, eps + eps * (a - zg) / b,
                          eps * np.exp(-(zg - a) / b))
    w = np.exp(-U / kT)
    z_mean_exact = np.trapezoid(zg * w, zg) / np.trapezoid(w, zg)
    assert np.isclose(z.mean(), z_mean_exact, rtol=0.1)


def test_adaptive_burn_in_changes_proposal():
    system = _single_blob_system()
    mc, _, _ = tmcmc.run_mcmc(system, _state(1.0),
                              torch.Generator().manual_seed(1), n_steps=10,
                              save_every=10, initial_step=-200)
    assert abs(float(mc.max_translation) - 0.1 * system.blob_radius) > 1e-6


def test_rejection_sampler_bounds():
    system = _single_blob_system()
    res = tmcmc.run_rejection_sampler(system,
                                      torch.Generator().manual_seed(2),
                                      n_steps=200, n_estimate=200,
                                      device="cpu")
    energies, accepted = to_np(res.energies), to_np(res.accepted)
    assert accepted.sum() > 0
    assert np.all(energies >= float(res.minimum_energy))
    assert np.all(np.isfinite(to_np(res.states.pos)[accepted]))


def test_entry_points_need_the_card_unless_told_cpu():
    """The rejection sampler runs on the card unless told otherwise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmcmc.run_rejection_sampler(_single_blob_system(), n_steps=1)
