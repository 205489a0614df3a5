"""The port's multiple devices (rigidmultiblobswall_tpu_torch/parallel) on
CPU gloo ranks against the JAX package's mesh on the 8-device virtual CPU
mesh (tests/conftest.py), in float64.

The ranks run in fresh processes (parallel/spawn.py, a FileStore under
the test's temporary directory), one pool a world size for every case,
which return their outputs through files; the processes import torch and
the port alone, the JAX oracle runs here.

- Pairwise products, D = 2 and 8, n = 16 and 37 (rows that do not divide
  evenly), against JAX's pairwise_matvec(..., mesh=make_mesh(8)) at
  1e-12: tt, tr, rt, rr on single_wall and no_wall, tt on free_surface,
  tt and tr on in_plane, open and with a periodic_length; a two-tensor
  product with self_interaction=True (the target rows' self pairs on a
  rank's share); 600 blobs, whose 15 group pairs split unevenly; the
  grand product.
- The spectral products (K6 over a cell range, the distributed FFT) and
  the wall products (K7 over a column range, the ky-padded transpose),
  D = 2 and 4, B = 1 and 2, against JAX's single-device matvec at JAX's
  own sharded tolerances, 1e-11 and 1e-10 x max|u|; grids that do not
  divide into 4 ranks (the replicated wave) and a mixed-radii periodic
  plan (P2 over a target range, the wave replicated).
- dryrun_multichip(2), the five paths of the JAX entry point, against
  their single-rank twins at 1e-12.
- A rank that leaves out a collective fails the run at the group's
  timeout; a mesh of several ranks without a process group raises.
"""

import concurrent.futures
import dataclasses
import functools
import time

import jax.numpy as jnp
import numpy as np
import pytest

from rigidmultiblobswall_tpu.ops import ewald as jew
from rigidmultiblobswall_tpu.ops import ewald_wall as jeww
from rigidmultiblobswall_tpu.ops import mobility as jmob
from rigidmultiblobswall_tpu.parallel.mesh import make_mesh as jax_mesh
from rigidmultiblobswall_tpu_torch.parallel import dryrun as pdry
from rigidmultiblobswall_tpu_torch.parallel import mesh as pmesh
from rigidmultiblobswall_tpu_torch.parallel import spawn as pspawn

from torch_parity import jax_zdft64

ETA, A = 1.1, 0.3
RUN_S = 240.0


def _blobs(n, seed, spread=2.0):
    rng = np.random.default_rng(seed)
    r = rng.uniform(-spread, spread, (n, 3))
    r[:, 2] = rng.uniform(0.5, 3.0, n)
    return r, rng.normal(size=(n, 3)), rng.normal(size=(n, 3))


def _pair_cases():
    cases = {}
    couplings = {"single_wall": ("tt", "tr", "rt", "rr"),
                 "no_wall": ("tt", "tr", "rt", "rr"),
                 "free_surface": ("tt",), "in_plane": ("tt", "tr")}
    for domain, cs in couplings.items():
        for coupling in cs:
            for n in ((16, 37) if domain in ("single_wall", "free_surface")
                      else (37,)):
                cases[f"{domain}-{coupling}-{n}"] = dict(
                    coupling=coupling, domain=domain, n=n)
    cases["single_wall-tt-box"] = dict(coupling="tt", domain="single_wall",
                                       n=37, periodic_length=(5.0, 5.0, 0.0))
    cases["single_wall-rr-box"] = dict(coupling="rr", domain="single_wall",
                                       n=37, periodic_length=(5.0, 5.0, 0.0))
    cases["no_wall-tt-box3"] = dict(coupling="tt", domain="no_wall", n=37,
                                    periodic_length=(5.0, 5.0, 5.0))
    cases["two_tensor-self"] = dict(coupling="tt", domain="single_wall",
                                    n=37, two_tensor=True)
    cases["groups-600"] = dict(coupling="tt", domain="single_wall", n=600,
                               spread=8.0)
    cases["grand"] = dict(coupling="grand", domain="single_wall", n=37)
    return cases


PAIR_CASES = _pair_cases()


def _pair_inputs(name):
    c = PAIR_CASES[name]
    r, v, t = _blobs(c["n"], hash(name) % 1000, c.get("spread", 2.0))
    kw = dict(domain=c["domain"],
              periodic_length=c.get("periodic_length", (0.0, 0.0, 0.0)))
    return c, r, v, t, kw


def _pair_port_case(name):
    c, r, v, t, kw = _pair_inputs(name)
    if c["coupling"] == "grand":
        return dict(kind="grand", r=r, f=v, t=t, eta=ETA, a=A, **kw)
    return dict(kind="pairwise", r=r, r_tgt=r if c.get("two_tensor") else
                None, v=v[None], eta=ETA, a=A, coupling=c["coupling"], **kw)


@functools.lru_cache(maxsize=None)
def _pair_oracle(name):
    c, r, v, t, kw = _pair_inputs(name)
    mesh = jax_mesh(8)
    if c["coupling"] == "grand":
        u, w = jmob.grand_mobility_matvec(jnp.asarray(r), jnp.asarray(v),
                                          jnp.asarray(t), ETA, A, mesh=mesh,
                                          **kw)
        return np.concatenate([np.asarray(u), np.asarray(w)], axis=1)
    return np.asarray(jmob.pairwise_matvec(
        jnp.asarray(r), jnp.asarray(r), jnp.asarray(v), ETA, A,
        coupling=c["coupling"], self_interaction=True, mesh=mesh, **kw))


# spectral and wall scenes: (kind, params, n, B). Both grids are 36 a
# side: divisible into 2 and 4 ranks (the distributed FFT), not into 8
# (the replicated wave)
SPEC_BOX = (12.5, 12.5, 12.5)
RADII_BOX = (18.0, 18.0, 18.0)
A_W, L_W = 0.25, 6.5
SPEC = dict(a=0.5, eta=1.3, box=SPEC_BOX, tol=0.1, grid_max=36)
WALL = dict(a=A_W, eta=0.9, box_xy=(L_W, L_W), z_hi=3.5 * A_W, tol=1e-2)
GRID_CASES = {
    "spectral": ("spectral", SPEC, 150, 1),
    "spectral-B2": ("spectral", SPEC, 150, 2),
    "spectral-radii": ("spectral", dict(a=0.45, eta=1.3, box=RADII_BOX,
                                        tol=1e-3, grid_max=64,
                                        radii=(0.25, 0.45)), 120, 2),
    "wall": ("wall", WALL, 40, 1),
    "wall-B2": ("wall", WALL, 40, 2),
}
GRID_TOL = {"spectral": 1e-11, "wall": 1e-10}


def _grid_inputs(name):
    kind, params, n, B = GRID_CASES[name]
    # a B = 2 case shares its B = 1 case's positions (and JAX's plan)
    rng = np.random.default_rng(len(name.replace("-B2", "")))
    if kind == "spectral":
        L = params["box"][0]
        pos = rng.uniform(-1.0, L + 1.0, (n, 3))
    else:
        L = params["box_xy"][0]
        pos = np.stack([rng.uniform(0, L, n), rng.uniform(0, L, n),
                        rng.uniform(1.2 * A_W, 3.0 * A_W, n)], axis=1)
    f = np.random.default_rng(B).normal(size=(B, n, 3))
    groups = (rng.integers(0, 2, n).astype(np.int32) if "radii" in params
              else None)
    return kind, params, pos, f, groups


def _grid_port_case(name):
    kind, params, pos, f, groups = _grid_inputs(name)
    case = dict(kind=kind, params=params, pos=pos,
                f=f if f.shape[0] > 1 else f[0])
    if groups is not None:
        case["group_of"] = groups
    return case


@functools.lru_cache(maxsize=None)
def _jax_plan(base):
    kind, params, pos, _, groups = _grid_inputs(base)
    if kind == "spectral":
        pj = dataclasses.replace(jew.default_params(**params),
                                 near_impl="xla")
        return jew.make_plan(pj, jnp.asarray(pos), group_of=None
                             if groups is None else jnp.asarray(groups))
    return jeww.make_wall_plan(
        jeww.default_wall_params(near_impl="xla", **params),
        jnp.asarray(pos))


@functools.lru_cache(maxsize=None)
def _grid_oracle(name):
    """JAX's single-device product, one right-hand side a call on the
    plan of the case's positions (float64 z-DFT matrices on the wall)."""
    kind, _, _, f, _ = _grid_inputs(name)
    old = jeww._host_zdft
    jeww._host_zdft = jax_zdft64
    try:
        plan = _jax_plan(name.replace("-B2", ""))
        mod = jew if kind == "spectral" else jeww
        return np.stack([np.asarray(mod.matvec(plan, jnp.asarray(fb)))
                         for fb in f])
    finally:
        jeww._host_zdft = old


# the pools: one spawn a world size, every case of that size
POOLS = {2: tuple(PAIR_CASES) + tuple(GRID_CASES),
         4: tuple(GRID_CASES),
         8: tuple(PAIR_CASES) + ("spectral", "wall")}


def _run_pool(world, workdir):
    names = POOLS[world]
    cases = [(_pair_port_case(n) if n in PAIR_CASES else _grid_port_case(n))
             for n in names]
    res = pspawn.spawn(world, "rigidmultiblobswall_tpu_torch.parallel."
                       "dryrun:products", cases, device="cpu",
                       run_s=RUN_S, threads=1, workdir=workdir)
    return dict(zip(names, (r["out"] for r in res["results"]))), res


_RUNS = {}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The module's rank runs, all started at once in the background (the
    JAX oracles compile here meanwhile); tests wait on theirs."""
    path = str(tmp_path_factory.mktemp("ranks"))
    pool = concurrent.futures.ThreadPoolExecutor(len(POOLS) + 1)
    for world in POOLS:
        _RUNS[world] = pool.submit(_run_pool, world, path)
    _RUNS["dryrun"] = pool.submit(
        pdry.dryrun_multichip, 2, device="cpu", dtype="float64", tol=1e-12,
        run_s=RUN_S, workdir=path)
    for name in PAIR_CASES:
        _pair_oracle(name)
    for name in GRID_CASES:
        _grid_oracle(name)
    yield path
    pool.shutdown(wait=True)
    _RUNS.clear()


def _pool(world, workdir):
    return _RUNS[world].result()


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("world", [2, 8])
@pytest.mark.parametrize("name", list(PAIR_CASES))
def test_sharded_pairwise_matches_jax_mesh(world, name, workdir):
    got = _pool(world, workdir)[0][name]
    ref = _pair_oracle(name)
    got = got[0] if got.ndim == 3 else got
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-12 * max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("world, name", [
    (w, n) for w in (2, 4, 8) for n in GRID_CASES if n in POOLS[w]])
def test_sharded_spectral_and_wall_match_jax(world, name, workdir):
    got = _pool(world, workdir)[0][name]
    ref = _grid_oracle(name)
    got = got[None] if got.ndim == 2 else got
    assert got.shape == ref.shape
    assert _rel(got, ref) <= GRID_TOL[GRID_CASES[name][0]]


def test_pools_ran_the_rank_shares_and_collectives(workdir):
    """The products went through the collectives: two all_to_all a
    spectral product with its wave sharded, three a wall product; at 8
    ranks, which do not divide the 36-point grids, and on the mixed-radii
    plan the wave runs replicated and sends none."""
    pools = {w: _pool(w, workdir)[1] for w in POOLS}
    for w, res in pools.items():
        assert res["counts"]["all_reduce_sum"][0] > 0
    for w in (2, 4):
        assert pools[w]["counts"]["all_to_all"][0] == 2 * 2 + 3 * 2
        assert pools[w]["replicated_wave"] == {"spectral": {"grid": 0,
                                                            "radii": 1},
                                               "wall": {"grid": 0}}
    assert pools[8]["counts"]["all_to_all"][0] == 0
    assert pools[8]["replicated_wave"] == {"spectral": {"grid": 1,
                                                        "radii": 0},
                                           "wall": {"grid": 1}}


def test_dryrun_multichip_matches_single_rank(workdir):
    res = _RUNS["dryrun"].result()
    assert tuple(res["paths"]) == pdry.PATHS
    # the paths' products went through the collectives (on the CPU the
    # shares take the plain versions, which count no launch)
    assert res["counts"]["all_reduce_sum"][0] > 0
    assert res["counts"]["broadcast"][0] > 0 and res["share_launches"] == {}
    for which, r in res["paths"].items():
        assert r["rel"] <= 1e-12, which
        assert r["counts"] == r["counts_single"], which


def test_rank_that_skips_a_collective_fails_within_the_timeout(workdir):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 ended"):
        pspawn.spawn(2, "rigidmultiblobswall_tpu_torch.parallel.dryrun:"
                     "skip_collective_rank", dict(wait_s=9.0), device="cpu",
                     timeout_s=3.0, run_s=60.0, workdir=workdir)
    assert time.monotonic() - t0 < 45.0


def test_mesh_without_process_group():
    with pytest.raises(RuntimeError, match="no torch.distributed"):
        pmesh.make_mesh(2, device="cpu")
    one = pmesh.make_mesh(1, device="cpu")
    assert (one.size, one.rank, one.group) == (1, 0, None)
    assert not pmesh.is_sharded(one) and one.rows(37) == (0, 37)
