"""Trajectory analysis: MSD (direct and FFT), rotational MSD, trajectory
text I/O, mobility origin transfer, and the structure factors of the CLI's
call_HydroGrid option.

Counterpart of rigidmultiblobswall_tpu/utils/analysis.py (functional
versions of the reference's general_application_utils.py:230-485): host
numpy, with the port's ops/quaternion (torch on the CPU) for the rotation
matrices.
"""

from __future__ import annotations

import os

import numpy as np


def msd_direct(x, max_lag=None):
    """Scalar/vector MSD by direct lag averaging: x (T,) or (T, d).
    Returns (max_lag,) array with msd[tau] = <|x(t+tau)-x(t)|^2>."""
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    T = x.shape[0]
    max_lag = max_lag or T // 2
    out = np.zeros(max_lag)
    for tau in range(1, max_lag):
        d = x[tau:] - x[:-tau]
        out[tau] = np.mean(np.sum(d * d, axis=1))
    return out


def msd_fft(x, max_lag=None):
    """FFT-based MSD, O(T log T) (the reference's fft_msd idea,
    general_application_utils.py:305-336, using the standard
    Kneller/Calandrini algorithm). x (T,) or (T, d)."""
    x = np.asarray(x, dtype=float)
    if x.ndim == 1:
        x = x[:, None]
    T = x.shape[0]
    max_lag = max_lag or T // 2

    # S2 via autocorrelation with zero padding
    n_fft = 1 << (2 * T - 1).bit_length()
    S2 = np.zeros(T)
    for dim in range(x.shape[1]):
        f = np.fft.rfft(x[:, dim], n_fft)
        acf = np.fft.irfft(f * np.conjugate(f), n_fft)[:T].real
        S2 += acf
    S2 /= np.arange(T, 0, -1)

    D = np.append(np.sum(x * x, axis=1), 0.0)
    Q = 2.0 * np.sum(D)
    S1 = np.zeros(T)
    for m in range(T):
        Q -= D[m - 1] + D[T - m]
        S1[m] = Q / (T - m)
    return (S1 - 2 * S2)[:max_lag]


def rotational_msd(locations, quaternions, max_lag=None):
    """6x6 translation-rotation MSD matrix per lag
    (general_application_utils.py:230-303 semantics): the rotational
    displacement of a lag is sum_i u_i x u_i' / 2 over the three rotated
    axes. Returns (max_lag, 6, 6)."""
    import torch

    from ..ops import quaternion as quat

    locations = np.asarray(locations)
    R = quat.rotation_matrix(torch.as_tensor(
        np.asarray(quaternions, dtype=np.float64))).numpy()
    T = locations.shape[0]
    max_lag = max_lag or T // 2
    out = np.zeros((max_lag, 6, 6))
    for tau in range(1, max_lag):
        dx = locations[tau:] - locations[:-tau]
        # rotation displacement: 1/2 sum_i u_i(t) x u_i(t+tau)
        u0 = R[:-tau]  # (n,3,3), axes are columns
        u1 = R[tau:]
        drot = 0.5 * np.sum(np.cross(u0.transpose(0, 2, 1),
                                     u1.transpose(0, 2, 1), axis=2), axis=1)
        d6 = np.concatenate([dx, drot], axis=1)
        out[tau] = np.einsum("ni,nj->ij", d6, d6) / d6.shape[0]
    return out


def write_trajectory_to_txt(file_name, trajectory, params, location=True):
    """Reference-format trajectory file
    (general_application_utils.py:338-366)."""
    dir_name = os.path.dirname(file_name)
    if dir_name and not os.path.isdir(dir_name):
        os.makedirs(dir_name, exist_ok=True)
    with open(file_name, "w") as f:
        f.write("Parameters:\n")
        for key, value in params.items():
            f.write("%s: %s \n" % (key, value))
        f.write("Trajectory data:\n")
        if location:
            f.write("Location, Orientation:\n")
            for x, theta in zip(trajectory[0], trajectory[1]):
                f.write("%s, %s, %s, %s, %s, %s, %s \n" % (
                    x[0], x[1], x[2], theta[0], theta[1], theta[2], theta[3]))
        else:
            f.write("Orientation:\n")
            for theta in trajectory[0]:
                f.write("%s, %s, %s, %s \n" % tuple(theta))


def read_trajectory_from_txt(file_name, location=True):
    """Read the reference trajectory format; returns (params, locations,
    orientations) (general_application_utils.py:368-415)."""
    params = {}
    locations = []
    orientations = []
    with open(file_name, "r") as f:
        f.readline()  # 'Parameters:'
        line = f.readline()
        while line and line != "Trajectory data:\n":
            key, _, value = line.partition(":")
            params[key.strip()] = value.strip()
            line = f.readline()
        f.readline()  # header line
        for line in f:
            parts = [p for p in line.replace(",", " ").split() if p]
            if not parts:
                continue
            vals = [float(p) for p in parts]
            if location:
                locations.append(vals[0:3])
                orientations.append(vals[3:7])
            else:
                orientations.append(vals[0:4])
    return params, np.array(locations), np.array(orientations)


def _tensor_cross_vector(T, v):
    out = np.zeros((3, 3))
    for k in range(3):
        for l in range(3):
            out[k, l] = (T[k, (l + 1) % 3] * v[(l - 1) % 3]
                         - T[k, (l - 1) % 3] * v[(l + 1) % 3])
    return out


def _vector_cross_tensor(v, T):
    out = np.zeros((3, 3))
    for k in range(3):
        for l in range(3):
            out[k, l] = (T[(k - 1) % 3, l] * v[(k + 1) % 3]
                         - T[(k + 1) % 3, l] * v[(k - 1) % 3])
    return out


def transfer_mobility(mobility_1, point_1, point_2):
    """Move a 6x6 body mobility between evaluation points (Bernal &
    De La Torre formulas; general_application_utils.py:417-455)."""
    r = np.asarray(point_1, dtype=float) - np.asarray(point_2, dtype=float)
    m1 = np.asarray(mobility_1)
    m2 = np.zeros((6, 6))
    m2[3:6, 3:6] = m1[3:6, 3:6]
    m2[3:6, 0:3] = m1[3:6, 0:3] + _tensor_cross_vector(m1[3:6, 3:6], r)
    m2[0:3, 3:6] = m2[3:6, 0:3].T
    m2[0:3, 0:3] = (m1[0:3, 0:3]
                    + _tensor_cross_vector(m1[0:3, 3:6], r)
                    - _vector_cross_tensor(r, m1[3:6, 0:3])
                    - _vector_cross_tensor(
                        r, _tensor_cross_vector(m1[3:6, 3:6], r)))
    return m2


class StructureFactor:
    """On-the-fly 2-species concentration structure factors — the
    package's analog of the reference's optional HydroGrid coupling
    (multi_bodies/multi_bodies.py:1396-1409, :1479-1613; options
    call_HydroGrid / sample_HydroGrid / save_HydroGrid / cells /
    green_particles of read_input.py:86-93).

    Each sample bins blob centers into an (nx, ny) xy concentration
    field per species (green = indices [g0, g1), red = the rest),
    accumulates the rfft2 cross-spectra <dc_a(k) conj(dc_b(k))> with
    the per-sample mean subtracted, and writes radially-binned
    S_gg/S_rr/S_gr(k) normalized per particle. Host-side numpy on the
    saved configurations (same cadence the reference calls HydroGrid's
    updateHydroGrid)."""

    def __init__(self, Lx, Ly, cells, green_particles, n_blobs):
        self.Lx, self.Ly = float(Lx), float(Ly)
        self.nx, self.ny = int(cells[0]), int(cells[1])
        g0, g1 = int(green_particles[0]), int(green_particles[1])
        mask = np.zeros(n_blobs, bool)
        mask[g0:g1] = True
        self.green = mask
        self.n_samples = 0
        ny2 = self.ny // 2 + 1
        self.acc = np.zeros((3, self.nx, ny2))

    def _field(self, pos, sel):
        ix = np.mod(np.floor(pos[sel, 0] / self.Lx * self.nx).astype(int),
                    self.nx)
        iy = np.mod(np.floor(pos[sel, 1] / self.Ly * self.ny).astype(int),
                    self.ny)
        c = np.zeros((self.nx, self.ny))
        np.add.at(c, (ix, iy), 1.0)
        return c - c.mean()

    def sample(self, positions):
        pos = np.asarray(positions)
        cg = np.fft.rfft2(self._field(pos, self.green))
        cr = np.fft.rfft2(self._field(pos, ~self.green))
        self.acc[0] += (cg * np.conj(cg)).real
        self.acc[1] += (cr * np.conj(cr)).real
        self.acc[2] += (cg * np.conj(cr)).real
        self.n_samples += 1

    def radial(self):
        """(k_centers, S_gg, S_rr, S_gr) radially binned, normalized per
        particle (S -> 1 for an ideal gas at large k)."""
        n = max(self.n_samples, 1)
        ntot = max(int(self.green.size), 1)
        kx = 2 * np.pi * np.fft.fftfreq(self.nx, d=self.Lx / self.nx)
        ky = 2 * np.pi * np.fft.rfftfreq(self.ny, d=self.Ly / self.ny)
        kmag = np.sqrt(kx[:, None] ** 2 + ky[None, :] ** 2)
        dk = 2 * np.pi / max(self.Lx, self.Ly)
        nb = int(np.ceil(kmag.max() / dk)) + 1
        which = np.minimum((kmag / dk).astype(int), nb - 1)
        counts = np.bincount(which.ravel(), minlength=nb)
        out = []
        for a in range(3):
            s = np.bincount(which.ravel(),
                            weights=(self.acc[a] / (n * ntot)).ravel(),
                            minlength=nb)
            out.append(s / np.maximum(counts, 1))
        keep = counts > 0
        k_centers = (np.arange(nb) + 0.5) * dk
        return (k_centers[keep],) + tuple(o[keep] for o in out)

    def save(self, path):
        k, sgg, srr, sgr = self.radial()
        header = (f"structure factors, {self.n_samples} samples, "
                  "columns: k S_gg S_rr S_gr (per-particle norm)")
        np.savetxt(path, np.stack([k, sgg, srr, sgr], axis=1),
                   header=header)
