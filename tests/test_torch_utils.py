"""The PyTorch port's utils/ (timer, tools, analysis with the structure
factors, gr with its native core) against the JAX package's on the same
numpy inputs; the port's native/gr.cpp a copy of the JAX package's, built
under the checkout, against its numpy fallback; and no module of the port
(nor chip_smoke.py) importing jax or the JAX package."""

import ast
import os
from pathlib import Path

import numpy as np
import pytest

from rigidmultiblobswall_tpu.utils import analysis as janalysis
from rigidmultiblobswall_tpu.utils import gr as jgr
from rigidmultiblobswall_tpu.utils import timer as jtimer
from rigidmultiblobswall_tpu.utils import tools as jtools
from rigidmultiblobswall_tpu_torch import native as tnative
from rigidmultiblobswall_tpu_torch.utils import analysis as tanalysis
from rigidmultiblobswall_tpu_torch.utils import gr as tgr
from rigidmultiblobswall_tpu_torch.utils import timer as ttimer
from rigidmultiblobswall_tpu_torch.utils import tools as ttools

from torch_parity import shell_vertices

ROOT = Path(__file__).resolve().parent.parent


def _trajectory(n_frames=6, n_bodies=5, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 6, (n_frames, n_bodies, 3))
    q = rng.normal(size=(n_frames, n_bodies, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.concatenate([pos, q], axis=-1)


def _write_config(path, traj):
    with open(path, "w") as f:
        for frame in traj:
            f.write("%d\n" % len(frame))
            for row in frame:
                f.write(" ".join("%.17g" % v for v in row) + "\n")


def test_timer_matches_jax(capsys):
    """The toggle timer, the context timer, totals and print_all keep the
    JAX package's semantics (each module its own totals)."""
    for mod in (jtimer, ttimer):
        mod.timer(None, clean_all=True)
        mod.timer("a")
        mod.timer("a", print_one=True)
        with mod.timed("b"):
            pass
        mod.timer("c")               # started, never stopped
        mod.print_all()
    out = capsys.readouterr().out.splitlines()
    names = [line.split(" = ")[0] for line in out]
    assert names == ["a", "a", "b", "a", "a", "b"]
    assert set(ttimer.totals()) == set(jtimer.totals()) == {"a", "b"}
    ttimer.timer(None, clean_all=True)
    assert ttimer.totals() == {}


def test_read_config_file_matches_jax(tmp_path):
    traj = _trajectory()
    _write_config(tmp_path / "run.shell.config", traj)
    got = ttools.read_config_file(str(tmp_path / "run.shell.config"))
    ref = jtools.read_config_file(str(tmp_path / "run.shell.config"))
    assert got.shape == ref.shape == (6, 5, 7)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, traj)


@pytest.mark.parametrize("radius", [None, 0.25])
def test_bodies_to_xyz_matches_jax(tmp_path, radius):
    """The expanded blob frames (rotation matrices by the port's torch
    quaternions against jax.numpy's) agree to 1e-12."""
    traj = _trajectory()
    ref_config = shell_vertices(12, 0.5)
    n = {}
    for name, mod in (("jax", jtools), ("torch", ttools)):
        n[name] = mod.bodies_to_xyz(traj, ref_config,
                                    str(tmp_path / f"{name}.xyz"),
                                    blob_radius=radius)
    assert n["torch"] == n["jax"] == 6 * 5 * 12

    def parse(path):
        lines = open(path).read().splitlines()
        assert lines[0] == "60" and lines[1] == "frame 0"
        return np.array([ln.split()[1:] for ln in lines
                         if ln.startswith("O ")], dtype=float)

    got, ref = parse(tmp_path / "torch.xyz"), parse(tmp_path / "jax.xyz")
    assert got.shape == ref.shape == (360, 3 if radius is None else 4)
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)


def test_histogram_and_average_files_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    data = rng.normal(size=(500, 3))
    with open(tmp_path / "h.dat", "w") as f:
        f.write("# a comment\n")
        for row in data:
            f.write("%.17g %.17g %.17g\n" % tuple(row))
        f.write("1 2 x\n")                   # not a number in column 2
    for column in (0, 2):
        got = ttools.histogram_from_file(str(tmp_path / "h.dat"), column,
                                         -2.0, 2.0, 16)
        ref = jtools.histogram_from_file(str(tmp_path / "h.dat"), column,
                                         -2.0, 2.0, 16)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    paths = []
    for k in range(3):
        paths.append(str(tmp_path / f"f{k}.dat"))
        np.savetxt(paths[-1], rng.normal(size=(4, 2)))
    for sub in (paths, paths[:1]):
        for g, r in zip(ttools.average_files(sub), jtools.average_files(sub)):
            np.testing.assert_array_equal(g, r)


def test_tools_main_matches_jax(tmp_path, capsys):
    """`python -m ...utils.tools` histogram, average and bodies-to-xyz:
    the same printed lines as the JAX package's."""
    rng = np.random.default_rng(4)
    np.savetxt(tmp_path / "d.dat", rng.normal(size=(50, 2)))
    np.savetxt(tmp_path / "e.dat", rng.normal(size=(50, 2)))
    _write_config(tmp_path / "t.config", _trajectory(2, 3))
    with open(tmp_path / "s.vertex", "w") as f:
        f.write("2\n0 0 0.5\n0 0 -0.5\n")
    for argv in (["histogram", str(tmp_path / "d.dat"), "1", "-1", "1",
                  "5"],
                 ["average", str(tmp_path / "d.dat"),
                  str(tmp_path / "e.dat")]):
        out = {}
        for name, mod in (("jax", jtools), ("torch", ttools)):
            mod._main(argv)
            out[name] = capsys.readouterr().out
        assert out["torch"] == out["jax"] and out["torch"]
    ttools._main(["bodies-to-xyz", str(tmp_path / "t.config"),
                  str(tmp_path / "s.vertex"), str(tmp_path / "t.xyz")])
    assert capsys.readouterr().out.startswith("wrote 12 blob rows")
    assert len(open(tmp_path / "t.xyz").read().splitlines()) == 2 * (2 + 6)


def test_msd_match_jax():
    rng = np.random.default_rng(5)
    x = np.cumsum(rng.normal(size=(64, 3)), axis=0)
    for fn in ("msd_direct", "msd_fft"):
        for arg, lag in ((x, None), (x[:, 0], 10)):
            got = getattr(tanalysis, fn)(arg, lag)
            ref = getattr(janalysis, fn)(arg, lag)
            np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(tanalysis.msd_fft(x)[1:],
                               tanalysis.msd_direct(x)[1:], rtol=1e-10)


def test_rotational_msd_matches_jax():
    """The 6x6 translation-rotation MSD (rotation matrices from the port's
    torch quaternions against jax.numpy's) to 1e-12."""
    traj = _trajectory(n_frames=20, n_bodies=1, seed=6)[:, 0]
    got = tanalysis.rotational_msd(traj[:, :3], traj[:, 3:], 8)
    ref = janalysis.rotational_msd(traj[:, :3], traj[:, 3:], 8)
    assert got.shape == ref.shape == (8, 6, 6)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("location", [True, False])
def test_trajectory_text_matches_jax(tmp_path, location):
    traj = _trajectory(n_frames=5, n_bodies=1, seed=7)[:, 0]
    data = [traj[:, :3], traj[:, 3:]] if location else [traj[:, 3:]]
    params = {"dt": 0.01, "n_steps": 5}
    tanalysis.write_trajectory_to_txt(str(tmp_path / "sub" / "t.txt"), data,
                                      params, location=location)
    janalysis.write_trajectory_to_txt(str(tmp_path / "j.txt"), data, params,
                                      location=location)
    assert ((tmp_path / "sub" / "t.txt").read_text()
            == (tmp_path / "j.txt").read_text())
    got = tanalysis.read_trajectory_from_txt(str(tmp_path / "j.txt"),
                                             location=location)
    ref = janalysis.read_trajectory_from_txt(str(tmp_path / "j.txt"),
                                             location=location)
    assert got[0] == ref[0]
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(g, r)


def test_transfer_mobility_matches_jax():
    rng = np.random.default_rng(8)
    m = rng.normal(size=(6, 6))
    m = m @ m.T
    p1, p2 = rng.normal(size=3), rng.normal(size=3)
    np.testing.assert_array_equal(tanalysis.transfer_mobility(m, p1, p2),
                                  janalysis.transfer_mobility(m, p1, p2))
    np.testing.assert_allclose(
        tanalysis.transfer_mobility(tanalysis.transfer_mobility(m, p1, p2),
                                    p2, p1), m, rtol=0, atol=1e-12)


def test_structure_factor_matches_jax(tmp_path):
    """Samples of 30 frames of 200 blobs (the first 80 green) in a 6 x 4
    box on 8 x 6 cells: the same accumulated spectra, radial bins and
    saved file as the JAX package's StructureFactor."""
    rng = np.random.default_rng(9)
    frames = rng.uniform(-1, 7, (30, 200, 3))
    sk = {}
    for name, mod in (("jax", janalysis), ("torch", tanalysis)):
        s = mod.StructureFactor(6.0, 4.0, (8, 6), (0, 80), 200)
        for f in frames:
            s.sample(f)
        s.save(str(tmp_path / f"{name}.dat"))
        sk[name] = s
    assert sk["torch"].n_samples == 30
    np.testing.assert_array_equal(sk["torch"].acc, sk["jax"].acc)
    for g, r in zip(sk["torch"].radial(), sk["jax"].radial()):
        np.testing.assert_array_equal(g, r)
    assert ((tmp_path / "torch.dat").read_text()
            == (tmp_path / "jax.dat").read_text())


@pytest.fixture(scope="module")
def slab():
    rng = np.random.default_rng(7)
    xyz = rng.uniform(0.0, 8.0, size=(5, 24, 3))
    xyz[..., 2] = rng.uniform(1.0, 2.0, size=(5, 24))
    return xyz


def test_gr_native_is_a_copy_built_in_the_checkout():
    """The port's native/gr.cpp is the JAX package's file, byte for byte,
    and builds under build/native/ of the checkout."""
    src = ROOT / "rigidmultiblobswall_tpu_torch" / "native" / "gr.cpp"
    assert src.read_bytes() == (ROOT / "rigidmultiblobswall_tpu" / "native"
                                / "gr.cpp").read_bytes()
    lib = tnative.load_library("gr")
    if lib is None:
        pytest.skip("no C++ toolchain")
    assert Path(lib._name).parent == ROOT / "build" / "native"
    assert tnative.load_library("missing") is None


@pytest.mark.parametrize("skip", [0, 2])
def test_gr_native_numpy_and_jax_agree(slab, skip):
    got = tgr.radial_distribution_pseudo2d(slab, 8.0, 8.0, n_bins=64,
                                           skip=skip)
    fallback = tgr.radial_distribution_pseudo2d(slab, 8.0, 8.0, n_bins=64,
                                                skip=skip, force_numpy=True)
    ref = jgr.radial_distribution_pseudo2d(slab, 8.0, 8.0, n_bins=64,
                                           skip=skip, force_numpy=True)
    for g, f, r in zip(got, fallback, ref):
        np.testing.assert_array_equal(f, r)
        np.testing.assert_array_equal(g, r)
    assert got[2].sum() > 0
    with pytest.raises(ValueError):
        tgr.radial_distribution_pseudo2d(slab[0, :, :2], 8.0, 8.0)
    with pytest.raises(ValueError):
        tgr.radial_distribution_pseudo2d(slab, 0.0, 8.0)


def test_gr_main_matches_jax(tmp_path, capsys, slab):
    traj = np.concatenate([slab, np.tile([1.0, 0, 0, 0], slab.shape[:2]
                                         + (1,))], axis=-1)
    _write_config(tmp_path / "g.config", traj)
    argv = [str(tmp_path / "g.config"), "8", "8", "--n-bins", "16",
            "--skip", "1"]
    tgr._main(argv)
    got = capsys.readouterr().out
    jgr._main(argv)
    ref = capsys.readouterr().out
    assert got == ref and len(got.splitlines()) == 16


def _imports(path):
    """The top-level module names a Python file imports (absolute
    imports; relative ones stay inside their package)."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_port_imports_neither_jax_nor_the_jax_package():
    files = [ROOT / "chip_smoke.py"] + sorted(
        (ROOT / "rigidmultiblobswall_tpu_torch").rglob("*.py"))
    assert len(files) > 40
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "rigidmultiblobswall_tpu"), \
                f"{os.path.relpath(path, ROOT)} imports {name}"
