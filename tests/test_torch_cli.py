"""The PyTorch port's CLI against the JAX package's CLI on one generated
4-shell input file: same final .clones (1e-8) after a few
stochastic_Slip_Trapz steps at kT = 0, same .velocity.dat for the
'mobility' scheme, the same .body_mobility.dat, .body_slip_mobility.dat
and resistance .force.dat (1e-10), the same mobility dumps and .clones
with update_PC = 2, and the same output files; on a generated
periodic_spectral input with tree (linked-cell) blob forces, the same
.clones and .info; on the example microroller input, the same
.clones and .info; on tests/test_cli.py's 4-sphere lubrication
input at kT = 0, the same .clones and deterministic .info counts; with
a Janus .Laplace file, the same body_mobility double-layer .dat, VTK
velocity and concentration fields (parsed) and phoretic .clones; the
phoretic_janus example with a generated vertex file, the same .config;
a user_defined_functions.py with body_force_torque_fn and postprocess
(jax.numpy for the JAX CLI, torch for the port's), the same .clones;
and a hook file importing jax ends the port's run with the pointer to
its hook signatures."""

import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu import cli as jcli
from rigidmultiblobswall_tpu_torch import cli as tcli
from rigidmultiblobswall_tpu_torch.io import input_file as tinput
from rigidmultiblobswall_tpu_torch.io import scene as tscene
from rigidmultiblobswall_tpu_torch.models import system as tsys

from torch_parity import jax_zdft64, shell_vertices, shells_scene

N_STEPS = 3


def _write_scene(d, scheme, n_bodies=4, kT=0.0, extra="", pos=None,
                 files=None):
    d.mkdir(parents=True, exist_ok=True)
    for name, text in (files or {}).items():
        (d / name).write_text(text)
    ref = shell_vertices(12, 0.5)
    with open(d / "shell.vertex", "w") as f:
        f.write("12\n")
        for x in ref:
            f.write("%.16g %.16g %.16g\n" % tuple(x))
    rng = np.random.default_rng(0)
    if pos is None:
        pos = np.stack([1.6 * (np.arange(n_bodies) % 2),
                        1.6 * (np.arange(n_bodies) // 2),
                        np.full(n_bodies, 0.9)], axis=1)
    quat = rng.normal(size=(n_bodies, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    with open(d / "shell.clones", "w") as f:
        f.write("%d\n" % n_bodies)
        for p, q in zip(pos, quat):
            f.write(" ".join("%.16g" % v for v in (*p, *q)) + "\n")
    with open(d / "input.dat", "w") as f:
        f.write(f"""# generated {n_bodies}-shell scene
scheme {scheme}
dt 0.002
n_steps {N_STEPS}
n_save {N_STEPS}
eta 1.0
g 0.1
blob_radius 0.131
kT {kT}
solver_tolerance 1e-12
repulsion_strength_wall 0.2
debye_length_wall 0.2
repulsion_strength 0.2
debye_length 0.2
blob_blob_force_implementation python
seed 1
output_name run
structure shell.vertex shell.clones
{extra}""")
    return d / "input.dat"


def _run_both(tmp_path, monkeypatch, scheme, **kw):
    out = {}
    for name, main, argv in (("jax", jcli.main, []),
                             ("torch", tcli.main,
                              ["--f64", "--device", "cpu"])):
        d = tmp_path / name
        inp = _write_scene(d, scheme, **kw)
        monkeypatch.chdir(d)
        main(["--input-file", str(inp)] + argv)
        out[name] = d
    return out


def _clones(path):
    return np.loadtxt(path, skiprows=1)


def test_cli_slip_trapz_matches_jax(tmp_path, monkeypatch):
    out = _run_both(tmp_path, monkeypatch, "stochastic_Slip_Trapz")
    final = "run.shell.%08d.clones" % N_STEPS
    ref = _clones(out["jax"] / final)
    got = _clones(out["torch"] / final)
    start = _clones(out["torch"] / "run.shell.00000000.clones")
    assert np.abs(got[:, :3] - start[:, :3]).max() > 1e-4
    np.testing.assert_allclose(got, ref, atol=1e-8, rtol=0)
    for suffix in (".info", ".time", ".inputfile", ".bodies_info"):
        assert (out["torch"] / ("run" + suffix)).is_file()
    info = dict(line.split() for line in
                open(out["torch"] / "run.info").read().splitlines())
    info_jax = dict(line.split() for line in
                    open(out["jax"] / "run.info").read().splitlines())
    assert info == info_jax


def test_cli_periodic_spectral_matches_jax(tmp_path, monkeypatch):
    """8 shells in a 3.2 box on the spectral engine (tolerance 0.2, a 32^3
    grid) with tree blob forces (linked cells; debye length 0.015 keeps
    4 cells of 2a + 30 b a side), 3 Slip-Trapz steps at kT = 0."""
    idx = np.arange(8)
    pos = np.stack([idx % 2, (idx // 2) % 2, idx // 4], axis=1) * 1.6 + 0.8
    extra = ("domain periodic_spectral\nperiodic_length 3.2 3.2 3.2\n"
             "spectral_tolerance 0.2\nspectral_grid_max 32\n"
             "blob_blob_force_implementation tree\ndebye_length 0.015\n")
    out = _run_both(tmp_path, monkeypatch, "stochastic_Slip_Trapz",
                    n_bodies=8, extra=extra, pos=pos)
    final = "run.shell.%08d.clones" % N_STEPS
    ref = _clones(out["jax"] / final)
    got = _clones(out["torch"] / final)
    disp = np.abs(ref[:, :3] - pos).max()
    assert disp > 1e-5
    np.testing.assert_allclose(got, ref, atol=1e-9 * max(disp, 1e-3),
                               rtol=0)
    info = dict(line.split() for line in
                open(out["torch"] / "run.info").read().splitlines())
    info_jax = dict(line.split() for line in
                    open(out["jax"] / "run.info").read().splitlines())
    assert info == info_jax


def test_cli_wall_spectral_matches_jax(tmp_path, monkeypatch):
    """4 shells in a 3.2 x 3.2 wall slab on the spectral wall engine
    (tolerance 1e-2; the slab height sized at the start, as both CLIs do)
    with tree blob forces (linked cells of the wall slab; debye length
    0.015 keeps 4 cells of 2a + 30 b a side), 3 Slip-Trapz steps at
    kT = 0; the JAX wave side with float64 z-DFT matrices."""
    from rigidmultiblobswall_tpu.ops import ewald_wall as jew

    monkeypatch.setattr(jew, "_host_zdft", jax_zdft64)
    pos = np.stack([1.6 * (np.arange(4) % 2) + 0.8,
                    1.6 * (np.arange(4) // 2) + 0.8,
                    [0.7, 0.9, 1.1, 0.8]], axis=1)
    extra = ("domain single_wall_spectral\nperiodic_length 3.2 3.2 0\n"
             "spectral_tolerance 1e-2\n"
             "blob_blob_force_implementation tree\ndebye_length 0.015\n")
    out = _run_both(tmp_path, monkeypatch, "stochastic_Slip_Trapz",
                    extra=extra, pos=pos)
    final = "run.shell.%08d.clones" % N_STEPS
    ref = _clones(out["jax"] / final)
    got = _clones(out["torch"] / final)
    disp = np.abs(ref[:, :3] - pos).max()
    assert disp > 1e-5
    np.testing.assert_allclose(got, ref, atol=1e-9 * max(disp, 1e-3),
                               rtol=0)
    info = dict(line.split() for line in
                open(out["torch"] / "run.info").read().splitlines())
    info_jax = dict(line.split() for line in
                    open(out["jax"] / "run.info").read().splitlines())
    assert info == info_jax


def test_cli_mobility_matches_jax(tmp_path, monkeypatch):
    out = _run_both(tmp_path, monkeypatch, "mobility")
    for name in ("run.velocity.dat", "run.force.dat"):
        ref = np.loadtxt(out["jax"] / name)
        got = np.loadtxt(out["torch"] / name)
        np.testing.assert_allclose(got, ref, atol=1e-9 * np.abs(ref).max(),
                                   rtol=0)


def _same_dat(out, name, tol=1e-10):
    ref = np.loadtxt(out["jax"] / name)
    got = np.loadtxt(out["torch"] / name)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=tol * np.abs(ref).max(),
                               rtol=0)


def test_cli_body_mobility_matches_jax(tmp_path, monkeypatch):
    out = _run_both(tmp_path, monkeypatch, "body_mobility")
    _same_dat(out, "run.body_mobility.dat")
    _same_dat(out, "run.body_slip_mobility.dat")
    assert np.loadtxt(out["torch"] / "run.body_mobility.dat").shape == (24,
                                                                       24)


def test_cli_resistance_matches_jax(tmp_path, monkeypatch):
    u = np.random.default_rng(3).normal(size=(4, 6))
    vel = "\n".join(" ".join("%.16g" % x for x in row) for row in u) + "\n"
    out = _run_both(tmp_path, monkeypatch, "resistance",
                    extra="velocity_file velocity.dat\n",
                    files={"velocity.dat": vel})
    _same_dat(out, "run.force.dat")
    assert np.abs(np.loadtxt(out["torch"] / "run.force.dat")).max() > 0


def test_cli_mobility_dumps_and_update_pc_match_jax(tmp_path, monkeypatch):
    """Slip-Trapz with update_PC 2 and the save_blobs_mobility /
    save_body_mobility dumps at every saved frame."""
    out = _run_both(tmp_path, monkeypatch, "stochastic_Slip_Trapz",
                    extra="update_PC 2\nsave_blobs_mobility True\n"
                          "save_body_mobility True\n")
    for k in (0, N_STEPS):
        _same_dat(out, "run.blobs_mobility.%08d.dat" % k)
        _same_dat(out, "run.body_mobility.%08d.dat" % k)
    final = "run.shell.%08d.clones" % N_STEPS
    np.testing.assert_allclose(_clones(out["torch"] / final),
                               _clones(out["jax"] / final), atol=1e-8,
                               rtol=0)


def janus_laplace(ref, mobility=5.0):
    """A .Laplace file's text for a shell of blobs ref (nb, 3): radial
    normals, weights 4 pi R^2 / nb, and a Janus split on the body-frame z
    as in examples/phoretic_janus/shell12_janus.Laplace (the upper half
    reacts, k = 5 and q = 0; the lower half emits, k = 0 and q = 1)."""
    R = np.linalg.norm(ref, axis=1)
    n = ref / R[:, None]
    w = 4 * np.pi * R.mean() ** 2 / len(ref)
    rows = [(*ni, 5.0, 0.0, mobility, w) if ni[2] >= 0 else
            (*ni, 0.0, 1.0, mobility, w) for ni in n]
    return "".join(" ".join("%.16g" % v for v in row) + "\n" for row in rows)


def _with_laplace(inp):
    inp.write_text(inp.read_text().replace(
        "structure shell.vertex shell.clones",
        "structure shell.vertex shell.clones shell.Laplace"))


def _run_laplace(tmp_path, monkeypatch, scheme, extra=""):
    """_run_both on the 4-shell scene with a Janus .Laplace file."""
    out = {}
    for name, main, argv in (("jax", jcli.main, []),
                             ("torch", tcli.main,
                              ["--f64", "--device", "cpu"])):
        d = tmp_path / name
        inp = _write_scene(d, scheme, extra=extra, files={
            "shell.Laplace": janus_laplace(shell_vertices(12, 0.5))})
        _with_laplace(inp)
        monkeypatch.chdir(d)
        main(["--input-file", str(inp)] + argv)
        out[name] = d
    return out


def test_cli_body_mobility_refuses_laplace_files(tmp_path, monkeypatch):
    """body_mobility with a .Laplace file: the double-layer slip mobility
    N K^T M^{-1} (I/2 + D) of its normals and weights, as the JAX CLI
    writes it, beside the plain mobilities."""
    out = _run_laplace(tmp_path, monkeypatch, "body_mobility")
    for name in ("run.body_mobility.dat", "run.body_slip_mobility.dat",
                 "run.body_slip_mobility_double_layer.dat"):
        _same_dat(out, name)
    dl = np.loadtxt(out["torch"] / "run.body_slip_mobility_double_layer.dat")
    plain = np.loadtxt(out["torch"] / "run.body_slip_mobility.dat")
    assert dl.shape == plain.shape == (24, 144)
    assert np.abs(dl - 0.5 * plain).max() > 1e-3


HOOKS_JAX = """import jax.numpy as jnp


def body_force_torque_fn(system, state, r_blobs):
    z = state.pos[:, 2]
    zero = 0.0 * z
    return jnp.stack([zero, 0.02 * z, zero, zero, zero, 0.3 + 0.1 * z],
                     axis=1)


def postprocess(system, state, step):
    return state._replace(pos=state.pos.at[:, 0].add(1e-3 * (step + 1)))
"""
HOOKS_TORCH = """import dataclasses

import torch


def body_force_torque_fn(system, state, r_blobs):
    z = state.pos[:, 2]
    zero = 0.0 * z
    return torch.stack([zero, 0.02 * z, zero, zero, zero, 0.3 + 0.1 * z],
                       dim=1)


def postprocess(system, state, step):
    pos = state.pos.clone()
    pos[:, 0] += 1e-3 * (step + 1)
    return dataclasses.replace(state, pos=pos)
"""


def test_cli_refuses_user_defined_functions(tmp_path, monkeypatch):
    """A user_defined_functions.py with body_force_torque_fn (which turns
    the body-body Yukawa force off) and postprocess, written in jax.numpy
    for the JAX CLI and in torch for the port's, in the run's directory:
    the same .clones and .info after 3 Slip-Trapz steps at kT = 0."""
    out = {}
    for name, main, argv, hooks in (
            ("jax", jcli.main, [], HOOKS_JAX),
            ("torch", tcli.main, ["--f64", "--device", "cpu"], HOOKS_TORCH)):
        d = tmp_path / name
        inp = _write_scene(d, "stochastic_Slip_Trapz", extra=(
            "body_body_force_torque_implementation python\n"),
            files={"user_defined_functions.py": hooks})
        monkeypatch.chdir(d)
        main(["--input-file", str(inp)] + argv)
        out[name] = d
    final = "run.shell.%08d.clones" % N_STEPS
    ref = _clones(out["jax"] / final)
    got = _clones(out["torch"] / final)
    start = _clones(out["torch"] / "run.shell.00000000.clones")
    disp = np.abs(ref[:, :3] - start[:, :3]).max()
    assert disp > 6e-3                    # the postprocess shifts alone
    np.testing.assert_allclose(got, ref, atol=1e-9 * disp, rtol=0)
    assert _info(out["torch"] / "run.info") == _info(out["jax"] / "run.info")


@pytest.mark.parametrize("line", ["import jax\n",
                                  "import jax.numpy as jnp\n",
                                  "from rigidmultiblobswall_tpu.models "
                                  "import system\n"])
def test_cli_user_functions_importing_jax_end_with_the_pointer(
        tmp_path, monkeypatch, line):
    """A hook file written for the JAX package ends the port's run with a
    SystemExit that names the port's torch hook signatures."""
    inp = _write_scene(tmp_path, "stochastic_Slip_Trapz", files={
        "user_defined_functions.py": line + "def slip_fn(s, t):\n"
                                            "    return None\n"})
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="torch functions.*blob_force_fn"):
        tcli.main(["--input-file", str(inp), "--f64", "--device", "cpu"])
    import jax                               # still importable afterwards

    assert jax.numpy is not None


def test_entry_points_need_the_card_unless_told_cpu(tmp_path, monkeypatch):
    """Without CUDA the CLI and the library entry points raise unless the
    caller asks for the CPU; nothing falls back quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    js, _, _, _, pos, quat = shells_scene(2)
    inp = _write_scene(tmp_path, "stochastic_Slip_Trapz")
    monkeypatch.chdir(tmp_path)
    for call in (lambda: tsys.make_state(pos, quat),
                 lambda: tsys.from_reference(js, pos, quat),
                 lambda: tinput.build_system(tinput.read_input(inp),
                                             base_dir=tmp_path),
                 lambda: tcli.main(["--input-file", str(inp)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not os.path.exists(tmp_path / "run.inputfile")
    assert tsys.make_state(pos, quat, device="cpu").pos.device.type == "cpu"


def test_cli_refuses_unported_inputs(tmp_path, monkeypatch):
    """examples/phoretic_janus (formerly refused) through both CLIs, its
    structure line pointed at a generated vertex file, R = 0.7921 times its
    .Laplace normals: the same .config frames to 1e-9 of the
    displacement, the phoretic slip driving the Janus shell."""
    src = Path(__file__).resolve().parent.parent / "examples" / \
        "phoretic_janus"
    laplace = np.loadtxt(src / "shell12_janus.Laplace")
    out = {}
    for name, main, argv in (("jax", jcli.main, []),
                             ("torch", tcli.main,
                              ["--f64", "--device", "cpu"])):
        d = tmp_path / name
        shutil.copytree(src, d)
        with open(d / "shell12.vertex", "w") as f:
            f.write("12\n")
            for x in 0.7921 * laplace[:, :3]:
                f.write("%.16g %.16g %.16g\n" % tuple(x))
        text = (d / "inputfile.dat").read_text().splitlines()
        text = [("structure shell12.vertex shell.clones "
                 "shell12_janus.Laplace") if ln.startswith("structure")
                else ln for ln in text]
        (d / "inputfile.dat").write_text("\n".join(text) + "\n")
        monkeypatch.chdir(d)
        main(["--input-file", str(d / "inputfile.dat")] + argv)
        out[name] = d

    def frames(d):
        rows = [ln.split() for ln in (d / "run.shell.config").read_text()
                .splitlines()]
        return np.array([r for r in rows if len(r) == 7], dtype=float)

    ref, got = frames(out["jax"]), frames(out["torch"])
    assert ref.shape == got.shape == (3, 7)      # steps 0, 2 and 4
    disp = np.abs(ref[:, :3] - ref[0, :3]).max()
    assert disp > 1e-3
    np.testing.assert_allclose(got, ref, atol=1e-9 * disp, rtol=0)


@pytest.mark.parametrize("scheme", [
    "articulated_deterministic_forward_euler_rollers",
    "articulated_deterministic_midpoint_rollers"])
def test_cli_articulated_matches_jax(tmp_path, monkeypatch, scheme):
    """The articulated_dumbbells example (8 single-blob bodies in four
    dumbbells) through both CLIs, 4 steps saved every 2, run from the
    example's copy (its .list_vertex names blob.vertex relative to the
    working directory): the same set of files (the JAX .random_state
    excepted, ROADMAP Queue 1, item 11), the same .clones of the
    articulated ID in the clones file's order to 1e-9 of the
    displacement, and the same .info, .bodies_info, .inputfile and
    .git."""
    src = Path(__file__).resolve().parents[1] / "examples" / (
        "articulated_dumbbells")
    edits = {"n_steps": "4", "n_save": "2", "scheme": scheme,
             "solver_tolerance": "1e-10"}
    out = {}
    for name, main, argv in (("jax", jcli.main, []),
                             ("torch", tcli.main,
                              ["--f64", "--device", "cpu"])):
        d = tmp_path / name
        shutil.copytree(src, d)
        lines = [ln for ln in (src / "inputfile.dat").read_text().splitlines()
                 if not ln.split() or ln.split()[0] not in edits]
        lines += [f"{k} {v}" for k, v in edits.items()]
        (d / "input.dat").write_text("\n".join(lines) + "\n")
        monkeypatch.chdir(d)
        main(["--input-file", str(d / "input.dat")] + argv)
        out[name] = d
    names = {k: {p.name for p in d.iterdir()} for k, d in out.items()}
    assert names["jax"] - names["torch"] == {"run_dumbbells.random_state"}
    assert names["torch"] - names["jax"] == set()
    start = _clones(src / "dumbbells.clones")
    for k in (0, 2, 4):
        f = "run_dumbbells.dumbbells.%08d.clones" % k
        ref, got = _clones(out["jax"] / f), _clones(out["torch"] / f)
        disp = np.abs(ref[:, :3] - start[:, :3]).max()
        np.testing.assert_allclose(got, ref, atol=1e-9 * max(disp, 1e-3),
                                   rtol=0)
    assert disp > 1e-4
    for f in ("run_dumbbells.info", "run_dumbbells.bodies_info",
              "run_dumbbells.inputfile", "run_dumbbells.git"):
        assert (out["torch"] / f).read_text() == (out["jax"] / f).read_text()


@pytest.mark.parametrize("scheme", ["stochastic_GDC_RFD",
                                    "deterministic_forward_euler"])
def test_cli_obstacles_match_jax(tmp_path, monkeypatch, scheme):
    """An input with an `obstacle` line (two shells held in place beside
    four free ones) at kT = 0: both CLIs write the same files, one
    .clones per structure ID, with the same free bodies' motion (1e-8)
    and the obstacles where they started."""
    obst = "".join("%.16g %.16g %.16g 1 0 0 0\n" % (x, 3.2, 0.9)
                   for x in (0.0, 1.6))
    out = _run_both(tmp_path, monkeypatch, scheme,
                    extra="obstacle shell.vertex wall.clones\n",
                    files={"wall.clones": "2\n" + obst})
    names = {k: {p.name for p in d.iterdir()} for k, d in out.items()}
    assert names["jax"] - names["torch"] == {"run.random_state"}
    assert names["torch"] - names["jax"] == set()
    for sid, n in (("shell", 4), ("wall", 2)):
        final = "run.%s.%08d.clones" % (sid, N_STEPS)
        got, ref = _clones(out["torch"] / final), _clones(out["jax"] / final)
        start = _clones(out["torch"] / ("run.%s.00000000.clones" % sid))
        assert got.shape == (n, 7)
        np.testing.assert_allclose(got, ref, atol=1e-8, rtol=0)
        moved = np.abs(got[:, :3] - start[:, :3]).max()
        assert moved > 1e-4 if sid == "shell" else moved == 0.0
    info = [dict(line.split() for line in
                 open(out[k] / "run.info").read().splitlines())
            for k in ("torch", "jax")]
    assert (info[0]["deterministic_iterations_count"]
            == info[1]["deterministic_iterations_count"])


def test_cli_rollers_matches_jax(tmp_path, monkeypatch):
    """The example microroller input (64 rollers, constrained omega,
    stochastic_adams_bashforth_rollers) at kT = 0: the same .clones every
    n_save steps and the same .info counters as the JAX CLI."""
    src = Path(__file__).resolve().parents[1] / "examples" / "rollers"
    edits = {"kT": "0.0", "n_steps": "3", "n_save": "2",
             "solver_tolerance": "1e-10"}
    out = {}
    for name, main, argv in (("jax", jcli.main, []),
                             ("torch", tcli.main,
                              ["--f64", "--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        for f in ("blob.vertex", "rollers.clones"):
            shutil.copyfile(src / f, d / f)
        lines = [ln for ln in (src / "inputfile.dat").read_text().splitlines()
                 if not ln.split() or ln.split()[0] not in edits]
        lines += [f"{k} {v}" for k, v in edits.items()]
        (d / "input.dat").write_text("\n".join(lines) + "\n")
        monkeypatch.chdir(d)
        main(["--input-file", str(d / "input.dat")] + argv)
        out[name] = d
    start = _clones(src / "rollers.clones")
    for k in (0, 2, 3):
        final = "run_rollers.rollers.%08d.clones" % k
        ref = _clones(out["jax"] / final)
        got = _clones(out["torch"] / final)
        disp = np.abs(ref[:, :3] - start[:, :3]).max()
        np.testing.assert_allclose(got, ref, atol=1e-9 * max(disp, 1e-3),
                                   rtol=0)
    assert disp > 1e-4
    info = dict(line.split() for line in
                open(out["torch"] / "run_rollers.info").read().splitlines())
    info_jax = dict(line.split() for line in
                    open(out["jax"] / "run_rollers.info").read().splitlines())
    assert info == info_jax and int(info["deterministic_iterations_count"]) > 0


def test_cli_rollers_wall_spectral_fails_like_jax(tmp_path, monkeypatch):
    """A rollers input with domain single_wall_spectral: the JAX CLI's
    rollers branch passes neither the spectral fields nor positions to
    init_carry, so its first step raises the engine's ValueError (no slab
    top); the port's CLI raises the same."""
    src = Path(__file__).resolve().parents[1] / "examples" / "rollers"
    edits = {"domain": "single_wall_spectral",
             "periodic_length": "40.0 40.0 0", "n_steps": "1",
             "n_save": "1", "kT": "0.0"}
    for name, main, argv in (("jax", jcli.main, []),
                             ("torch", tcli.main,
                              ["--f64", "--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        for f in ("blob.vertex", "rollers.clones"):
            shutil.copyfile(src / f, d / f)
        lines = [ln for ln in (src / "inputfile.dat").read_text().splitlines()
                 if not ln.split() or ln.split()[0] not in edits]
        lines += [f"{k} {v}" for k, v in edits.items()]
        (d / "input.dat").write_text("\n".join(lines) + "\n")
        monkeypatch.chdir(d)
        with pytest.raises(ValueError, match="spectral_wall_height > 0"):
            main(["--input-file", str(d / "input.dat")] + argv)


def test_cli_save_velocities_matches_jax(tmp_path, monkeypatch):
    """save_velocities True: every step's body velocities, stacked as
    (steps, 6 bodies), in .velocities.dat, as the JAX CLI writes them."""
    out = _run_both(tmp_path, monkeypatch, "stochastic_Slip_Trapz",
                    extra="save_velocities True\n")
    _same_dat(out, "run.velocities.dat")
    got = np.loadtxt(out["torch"] / "run.velocities.dat")
    assert got.shape == (N_STEPS, 6 * 4) and np.abs(got).max() > 0


@pytest.mark.parametrize("line, item", [
    ("random_state run.random_state", "item 11"),
])
def test_cli_refuses_unported_options(tmp_path, monkeypatch, line, item):
    """Options the JAX CLI acts on and the port does not support yet are
    refused, naming the ROADMAP item that ports them, not ignored."""
    inp = _write_scene(tmp_path, "stochastic_Slip_Trapz", extra=line + "\n")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=item):
        tcli.main(["--input-file", str(inp), "--f64", "--device", "cpu"])
    assert not os.path.exists(tmp_path / "run.inputfile")


def _same_vtk(out, name, tol=1e-5):
    """The two CLIs' VTK files of `name`, parsed, agree (%g keeps six
    digits)."""
    from test_torch_phoretic import read_vtk

    a = read_vtk(out["torch"] / name)
    b = read_vtk(out["jax"] / name)
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].shape == b[key].shape
        assert np.abs(a[key] - b[key]).max() <= tol * np.abs(b[key]).max()
    return a


GRID = "-1 3 4 -1 3 4 0.2 2.2 2"


@pytest.mark.parametrize("tracer", ["", "tracer_radius 0.1\n"])
def test_cli_mobility_velocity_field_matches_jax(tmp_path, monkeypatch,
                                                tracer):
    """scheme mobility with plot_velocity_field (point tracers, and tracers
    of radius 0.1): the same .velocity_field.vtk as the JAX CLI's."""
    out = _run_both(tmp_path, monkeypatch, "mobility",
                    extra=f"plot_velocity_field {GRID}\n{tracer}")
    v = _same_vtk(out, "run.velocity_field.vtk")
    assert v["velocity"].shape == (32, 3) and np.abs(v["velocity"]).max() > 0


def test_cli_mobility_concentration_field_matches_jax(tmp_path, monkeypatch):
    """scheme mobility of Janus shells (a .Laplace file) with
    plot_velocity_field and plot_concentration_field: both VTK files and
    .velocity.dat as the JAX CLI writes them."""
    out = _run_laplace(tmp_path, monkeypatch, "mobility", extra=(
        f"plot_velocity_field {GRID}\nplot_concentration_field {GRID}\n"
        "background_Laplace 1 0.1\n"))
    _same_dat(out, "run.velocity.dat")
    _same_vtk(out, "run.velocity_field.vtk")
    c = _same_vtk(out, "run.concentration_field.vtk")
    assert c["concentration"].shape == (32, 1)


def test_cli_phoretic_run_writes_concentration_frames_like_jax(
        tmp_path, monkeypatch):
    """A dynamic phoretic run (Janus shells, 3 Slip-Trapz steps at kT =
    0, saved every step) with plot_concentration_field: a
    .<step>.concentration_field.vtk with every saved frame, and the same
    .clones, as the JAX CLI writes them."""
    out = _run_laplace(tmp_path, monkeypatch, "stochastic_Slip_Trapz",
                       extra=f"plot_concentration_field {GRID}\n"
                             "n_save 1\n")
    for k in range(N_STEPS):
        _same_vtk(out, "run.%08d.concentration_field.vtk" % k)
    names = {p.name for p in out["torch"].iterdir()}
    assert "run.%08d.concentration_field.vtk" % N_STEPS not in names
    final = "run.shell.%08d.clones" % N_STEPS
    ref = _clones(out["jax"] / final)
    start = _clones(out["jax"] / "run.shell.00000000.clones")
    disp = np.abs(ref[:, :3] - start[:, :3]).max()
    np.testing.assert_allclose(_clones(out["torch"] / final), ref,
                               atol=1e-9 * disp, rtol=0)


def test_read_input_accepts_hydrogrid_off(tmp_path):
    inp = _write_scene(tmp_path, "stochastic_Slip_Trapz",
                       extra="call_HydroGrid False\nsave_velocities False\n")
    cfg = tinput.read_input(inp)
    assert cfg.options["call_HydroGrid"] == "False"


def _write_lubrication_scene(d, kT=0.0, extra=""):
    """tests/test_cli.py's generated 4-sphere lubrication input (trapezoidal,
    omega 25 with cut_torque 0.2, max_neighbors 3, Lub_Cut 4, the firm
    terms on), at solver tolerance 1e-10."""
    d.mkdir(parents=True, exist_ok=True)
    (d / "sphere.vertex").write_text("1\n0. 0. 0.\n")
    (d / "spheres.clones").write_text(
        "4\n0 0 1.2 1 0 0 0\n2.5 0 1.2 1 0 0 0\n"
        "0 2.5 1.2 1 0 0 0\n2.5 2.5 1.2 1 0 0 0\n")
    (d / "input.dat").write_text(f"""
scheme                lubrication_trapezoidal
n_steps               3
n_save                3
dt                    0.001
eta                   0.957e-3
blob_radius           1.0
kT                    {kT}
g                     0.0025
repulsion_strength    0.016
debye_length          0.1
repulsion_strength_wall 0.016
debye_length_wall     0.1
solver_tolerance      1e-10
seed                  0
omega                 25.0
cut_torque            0.2
max_neighbors         3
Lub_Cut               4.0
repulsion_strength_firm 0.0163
firm_delta            1e-2
output_name           run
structure             sphere.vertex spheres.clones
{extra}""")
    return d / "input.dat"


def _info(path):
    return dict(line.split() for line in open(path).read().splitlines())


def test_cli_lubrication_matches_jax(tmp_path, monkeypatch):
    """The lubrication branch at kT = 0 (no noise enters the step): the
    same .clones at steps 0 and 3 (1e-9 of the displacement) and the same
    rejection and deterministic iteration counts in .info as the JAX
    CLI."""
    out = {}
    for name, main, argv in (("jax", jcli.main, []),
                             ("torch", tcli.main,
                              ["--f64", "--device", "cpu"])):
        inp = _write_lubrication_scene(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        main(["--input-file", str(inp)] + argv)
        out[name] = tmp_path / name
    start = _clones(out["jax"] / "spheres.clones")
    for k in (0, 3):
        final = "run.spheres.%08d.clones" % k
        ref = _clones(out["jax"] / final)
        got = _clones(out["torch"] / final)
        disp = np.abs(ref[:, :3] - start[:, :3]).max()
        np.testing.assert_allclose(got, ref, atol=1e-9 * max(disp, 1e-3),
                                   rtol=0)
    assert disp > 1e-4
    # prescribed spin about +y near the wall rolls the spheres in +x
    assert np.mean(got[:, 0] - start[:, 0]) > 0
    info, info_jax = (_info(out[k] / "run.info") for k in ("torch", "jax"))
    for key in ("num_rejections_wall", "num_rejections_jump",
                "deterministic_iterations_count"):
        assert info[key] == info_jax[key], key
    assert int(info["deterministic_iterations_count"]) > 0
    for suffix in (".time", ".inputfile", ".bodies_info"):
        assert (out["torch"] / ("run" + suffix)).is_file()


def test_cli_lubrication_brownian_and_refusals(tmp_path, monkeypatch,
                                               capsys):
    """At kT > 0 the run writes the four .info counters and, with
    --print-residual, one line a step; a periodic box is refused before
    the run (K1's image boxes, ROADMAP item 4)."""
    inp = _write_lubrication_scene(tmp_path / "b", kT=0.004)
    monkeypatch.chdir(tmp_path / "b")
    tcli.main(["--input-file", str(inp), "--f64", "--device", "cpu",
               "--print-residual"])
    info = _info(tmp_path / "b" / "run.info")
    assert list(info) == ["num_rejections_wall", "num_rejections_jump",
                          "deterministic_iterations_count",
                          "stochastic_iterations_count"]
    assert int(info["stochastic_iterations_count"]) > 0
    assert capsys.readouterr().out.count("lubrication step") == 3
    pos = _clones(tmp_path / "b" / "run.spheres.00000003.clones")
    assert pos.shape == (4, 7) and np.all(np.isfinite(pos))
    inp = _write_lubrication_scene(tmp_path / "p",
                                   extra="periodic_length 10 10 0\n")
    monkeypatch.chdir(tmp_path / "p")
    with pytest.raises(NotImplementedError, match="item 4"):
        tcli.main(["--input-file", str(inp), "--f64", "--device", "cpu"])
    assert not (tmp_path / "p" / "run.spheres.00000000.clones").exists()


def test_cli_lubrication_example_runs_on_cpu(tmp_path, monkeypatch):
    """examples/lubrication_rollers/inputfile.dat (9 spheres, 10 steps,
    float32) through the port's CLI with --device cpu."""
    src = Path(__file__).resolve().parents[1] / "examples" / \
        "lubrication_rollers"
    for f in ("inputfile.dat", "sphere.vertex", "spheres.clones"):
        shutil.copyfile(src / f, tmp_path / f)
    monkeypatch.chdir(tmp_path)
    tcli.main(["--input-file", str(tmp_path / "inputfile.dat"), "--device",
               "cpu"])
    start = _clones(src / "spheres.clones")
    for k in (0, 5, 10):
        pos = _clones(tmp_path / ("run.spheres.%08d.clones" % k))
        assert pos.shape == start.shape and np.all(np.isfinite(pos))
    assert np.abs(pos[:, :3] - start[:, :3]).max() > 1e-4
    info = _info(tmp_path / "run.info")
    assert int(info["deterministic_iterations_count"]) > 0
    assert int(info["num_rejections_wall"]) == 0


def test_cli_writes_the_files_jax_writes(tmp_path, monkeypatch):
    """One Slip-Trapz run of each CLI on the same input writes the same set
    of files, the provenance stamp .git (`git rev-parse HEAD` in the
    package's directory) included, with the same content. The JAX CLI's
    .random_state (its PRNG key at the end of the run) is the one file the
    port does not write yet (ROADMAP Queue 1, item 11)."""
    out = _run_both(tmp_path, monkeypatch, "stochastic_Slip_Trapz")
    names = {k: {p.name for p in d.iterdir()} for k, d in out.items()}
    assert "run.git" in names["jax"]
    assert names["jax"] - names["torch"] == {"run.random_state"}
    assert names["torch"] - names["jax"] == set()
    assert ((out["torch"] / "run.git").read_text()
            == (out["jax"] / "run.git").read_text())


def _mcmc_info(path):
    """.MCMC_info as {key: value}."""
    return dict(line.split(" = ") for line in
                open(path).read().splitlines())


def _config_frames(path):
    """A .config file as its frames: [(n, rows (n, 7))]."""
    lines = open(path).read().splitlines()
    frames, i = [], 0
    while i < len(lines):
        n = int(lines[i])
        rows = np.array([ln.split() for ln in lines[i + 1:i + 1 + n]],
                        dtype=float)
        assert rows.shape == (n, 7)
        frames.append(rows)
        i += 1 + n
    return frames


@pytest.mark.parametrize("scheme, save_clones", [
    ("body_mcmc", "one_file"), ("MCMC", "one_file_per_step"),
    ("body_mcmc_rejection", "one_file")])
def test_cli_mcmc_modes_write_what_jax_writes(tmp_path, monkeypatch, scheme,
                                              save_clones):
    """The three MCMC modes through both CLIs on the generated 4-shell
    input (20 steps saved every 5 after 10 adaptive burn-in steps; the
    rejection sampler 200 proposals with n_estimate 500 at g 0.001): the
    same file names,
    the same .config / .clones layout and frame count, and the same
    .MCMC_info fields. The draws differ (torch's against JAX's), so the
    values are held to their ranges: frames above the wall, an acceptance
    ratio in (0, 1], and accepted_moves equal to it times the moves."""
    rejection = scheme == "body_mcmc_rejection"
    moves = 200 if rejection else 30
    extra = (f"n_steps {200 if rejection else 20}\nn_save 5\n"
             f"initial_step -10\nsave_clones {save_clones}\n"
             "n_estimate 500\n" + ("g 0.001\n" if rejection else ""))
    out = _run_both(tmp_path, monkeypatch, scheme, kT=1.0, extra=extra)
    names = {k: {p.name for p in d.iterdir()} for k, d in out.items()}
    assert names["torch"] == names["jax"] - {"run.random_state"}
    if scheme == "MCMC":
        clones = sorted(n for n in names["torch"] if n.endswith(".clones")
                        and n.startswith("run.shell."))
        assert clones == ["run.shell.%08d.clones" % s for s in (0, 5, 10,
                                                                15)]
        for name in clones:
            n, locs, _ = tscene.read_clones_file(out["torch"] / name)
            assert n == 4 and np.all(locs[:, 2] > 0)
    else:
        got = _config_frames(out["torch"] / "run.shell.config")
        ref = _config_frames(out["jax"] / "run.shell.config")
        if scheme == "body_mcmc":
            assert len(got) == len(ref) == 4
        else:
            assert len(got) > 0 and len(ref) > 0
        for frame in got:
            assert frame.shape == (4, 7) and np.all(np.isfinite(frame))
    info = _mcmc_info(out["torch"] / "run.MCMC_info")
    info_jax = _mcmc_info(out["jax"] / "run.MCMC_info")
    assert list(info) == list(info_jax)
    ratio = float(info["acceptance ratio"])
    assert 0 < ratio <= 1
    assert int(info["accepted_moves"]) == round(ratio * moves)
    for key, value in info.items():
        assert np.isfinite(float(value)), key


def test_cli_mcmc_example_runs_on_cpu(tmp_path, monkeypatch):
    """examples/mcmc/inputMCMC.dat through the port's CLI on the CPU, its
    structure line pointed at generated vertex and clones files (16
    twelve-blob shells of radius 1, a = 0.25): 200 steps after 100 burn-in
    steps, saved every 20: 10 frames in the .config file (moves 1, 21, ...,
    181), and the MCMC info."""
    src = Path(__file__).resolve().parent.parent / "examples" / "mcmc"
    text = (src / "inputMCMC.dat").read_text().splitlines()
    text = [("structure shell.vertex shell.clones")
            if ln.startswith("structure") else ln for ln in text]
    (tmp_path / "inputMCMC.dat").write_text("\n".join(text) + "\n")
    with open(tmp_path / "shell.vertex", "w") as f:
        f.write("12\n")
        for x in shell_vertices(12, 1.0):
            f.write("%.16g %.16g %.16g\n" % tuple(x))
    idx = np.arange(16)
    with open(tmp_path / "shell.clones", "w") as f:
        f.write("16\n")
        for i in idx:
            f.write("%g %g 1.5 1 0 0 0\n" % (3.0 * (i % 4), 3.0 * (i // 4)))
    monkeypatch.chdir(tmp_path)
    tcli.main(["--input-file", str(tmp_path / "inputMCMC.dat"), "--f64",
               "--device", "cpu"])
    frames = _config_frames(tmp_path / "run.shell.config")
    assert len(frames) == 10
    assert all(f.shape == (16, 7) for f in frames)
    info = _mcmc_info(tmp_path / "run.MCMC_info")
    assert 0 < float(info["acceptance ratio"]) <= 1
    assert float(info["final max_translation"]) != 0.025


def test_cli_hydrogrid_matches_jax(tmp_path, monkeypatch):
    """call_HydroGrid True on tests' periodic_spectral input (8 shells in a
    3.2 box, 3 Slip-Trapz steps at kT = 0), 4 x 4 cells with the first 48
    blobs green, sampled every step and saved every 2: the same
    .structure_factors.dat as the JAX CLI's (kT = 0: no draw enters)."""
    idx = np.arange(8)
    pos = np.stack([idx % 2, (idx // 2) % 2, idx // 4], axis=1) * 1.6 + 0.8
    extra = ("domain periodic_spectral\nperiodic_length 3.2 3.2 3.2\n"
             "spectral_tolerance 0.2\nspectral_grid_max 32\n"
             "blob_blob_force_implementation tree\ndebye_length 0.015\n"
             "call_HydroGrid True\ncells 4 4\ngreen_particles 0 48\n"
             "sample_HydroGrid 1\nsave_HydroGrid 2\n")
    out = _run_both(tmp_path, monkeypatch, "stochastic_Slip_Trapz",
                    n_bodies=8, extra=extra, pos=pos)
    name = "run.structure_factors.dat"
    head = [(out[k] / name).read_text().splitlines()[0] for k in out]
    assert head[0] == head[1] and "3 samples" in head[0]
    got = np.loadtxt(out["torch"] / name)
    ref = np.loadtxt(out["jax"] / name)
    assert got.shape == ref.shape and got.shape[1] == 4
    assert np.abs(ref[:, 1:]).max() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)
