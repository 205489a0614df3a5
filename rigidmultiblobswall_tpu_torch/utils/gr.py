"""Pseudo-2D radial distribution function g(r).

Counterpart of rigidmultiblobswall_tpu/utils/gr.py, a version of the
reference's standalone analysis executable (reference: multi_bodies/
examples/Radial_Dist_Test/gr_pseudo2D_single_blob.cpp:20-85): pair
distances use the minimum-image convention along x and y only but the
full 3D separation, and the histogram is normalized against the 2D
ideal-gas density rho = N / (lx * ly) — appropriate for quasi-2D systems
such as particles sedimented over a wall.

The pair sweep runs in the native C++/OpenMP core
(native/gr.cpp::gr_pseudo2d_accumulate, the port's copy of the JAX
package's) when a host toolchain is available, with a vectorized numpy
fallback; this is a host tool, not a device kernel. Normalization matches
the reference: g(r_bin) = hist / (n_frames * N * pi * rho * (r_up^2 -
r_low^2)) with dr = lx / (2 * n_bins).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..native import load_library


def _accumulate_numpy(xyz, lx, ly, dr, n_bins, skip):
    """Same contract as the native core, in vectorized numpy."""
    n_frames, n_p = xyz.shape[0], xyz.shape[1]
    hist = np.zeros(n_bins, dtype=np.int64)
    iu, ju = np.triu_indices(n_p, k=1)
    for f in range(skip, n_frames):
        d = xyz[f, iu] - xyz[f, ju]
        if lx > 0:
            d[:, 0] -= lx * np.rint(d[:, 0] / lx)
        if ly > 0:
            d[:, 1] -= ly * np.rint(d[:, 1] / ly)
        r = np.sqrt(np.sum(d * d, axis=1))
        bins = (r / dr).astype(np.int64)
        np.add.at(hist, bins[bins < n_bins], 2)
    return hist, max(n_frames - skip, 0)


def radial_distribution_pseudo2d(xyz, lx, ly, *, n_bins=2000, skip=0,
                                 force_numpy=False):
    """g(r) of a trajectory of point positions in a quasi-2D slab.

    xyz: (n_frames, N, 3) positions (a single frame (N, 3) is promoted);
    lx, ly: periodic box lengths in x and y (<=0 disables wrapping on
    that axis); n_bins bins of width dr = lx / (2 n_bins); the first
    `skip` frames are discarded.

    Returns (r_centers, g, hist): bin centers (i+1/2) dr, the normalized
    radial distribution, and the raw pair counts — the same three
    columns the reference executable prints.
    """
    xyz = np.ascontiguousarray(np.asarray(xyz, dtype=np.float64))
    if xyz.ndim == 2:
        xyz = xyz[None]
    if xyz.ndim != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"expected (frames, N, 3) positions, got {xyz.shape}")
    n_frames, n_p = xyz.shape[0], xyz.shape[1]
    dr = lx / (2.0 * n_bins)
    if dr <= 0:
        raise ValueError("lx must be positive (it sets the bin width)")

    lib = None if force_numpy else load_library("gr")
    if lib is not None:
        fn = lib.gr_pseudo2d_accumulate
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_double, ctypes.c_double,
                       ctypes.c_double, ctypes.c_int64, ctypes.c_int64,
                       ctypes.POINTER(ctypes.c_int64)]
        hist = np.zeros(n_bins, dtype=np.int64)
        n_used = fn(xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    n_frames, n_p, float(lx), float(ly), dr, n_bins,
                    int(skip),
                    hist.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    else:
        hist, n_used = _accumulate_numpy(xyz, lx, ly, dr, n_bins, skip)

    centers = (np.arange(n_bins) + 0.5) * dr
    edges = np.arange(n_bins + 1) * dr
    density = n_p / (lx * ly)
    n_ideal = np.pi * density * (edges[1:] ** 2 - edges[:-1] ** 2)
    denom = max(n_used, 1) * n_p * n_ideal
    return centers, hist / denom, hist


def _main(argv=None):
    import argparse

    from .tools import read_config_file

    p = argparse.ArgumentParser(
        prog="rigidmultiblobswall_tpu_torch.utils.gr",
        description="pseudo-2D radial distribution of a .config trajectory")
    p.add_argument("config", help=".config trajectory (one_file format)")
    p.add_argument("lx", type=float)
    p.add_argument("ly", type=float)
    p.add_argument("--n-bins", type=int, default=2000)
    p.add_argument("--skip", type=int, default=0)
    args = p.parse_args(argv)

    traj = read_config_file(args.config)[..., :3]
    r, g, hist = radial_distribution_pseudo2d(
        traj, args.lx, args.ly, n_bins=args.n_bins, skip=args.skip)
    for ri, gi, hi in zip(r, g, hist):
        print(f"{ri:.10g} {gi:.10g} {hi}")


if __name__ == "__main__":
    _main()
