"""Fluid velocity and phoretic concentration fields on a rectilinear grid
(PyTorch).

Counterpart of rigidmultiblobswall_tpu/models/fields.py: the velocity at
grid nodes is the source-target mobility product of the blob constraint
forces with target radius `tracer_radius` (ops/mobility.
source_target_matvec); the concentration is models/phoretic.
concentration_field (kernel L1 on the card). Both are written as legacy
VTK (io/vtk.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..io import vtk
from ..ops import mobility as mob
from . import kinematics as kin
from .system import State, System


def velocity_field_grid(grid_spec):
    """grid_spec: 9 floats (x0 x1 nx y0 y1 ny z0 z1 nz), the reference's
    column layout. Returns (coords (P, 3), mesh axes (x, y, z), counts),
    the nodes at the cell centres, x fastest."""
    grid = np.reshape(np.asarray(grid_spec, dtype=float), (3, 3)).T
    lengths = grid[1] - grid[0]
    counts = grid[2].astype(int)
    d = lengths / counts
    axes = [grid[0, k] + d[k] * (np.arange(counts[k]) + 0.5)
            for k in range(3)]
    zz, yy, xx = np.meshgrid(axes[2], axes[1], axes[0], indexing="ij")
    coords = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=1)
    mesh = [np.concatenate([axes[k] - 0.5 * d[k], [grid[1, k]]])
            for k in range(3)]
    return coords, mesh, counts


def evaluate_velocity_field(system: System, state: State, lam, grid_coords,
                            tracer_radius=0.0):
    """Velocity at grid_coords (P, 3) induced by blob forces lam (N, 3),
    each blob a source of its own radius (System.blob_radii), on the
    state's device and dtype. The wall's image system on single_wall and
    in_plane, as the JAX package's fields.py:40 takes it (unprojected);
    every other domain unbounded."""
    r_blobs = kin.blob_positions(system, state)
    tgt = torch.as_tensor(grid_coords, dtype=r_blobs.dtype,
                          device=r_blobs.device)
    radius_src = torch.tensor(system.blob_radii, dtype=r_blobs.dtype,
                              device=r_blobs.device)
    return mob.source_target_matvec(
        r_blobs, tgt, lam.reshape(-1, 3), radius_src, tracer_radius,
        system.eta, wall=system.domain in ("single_wall", "in_plane"),
        periodic_length=system.periodic_length)


def plot_concentration_field_to_vtk(grid_spec, system: System, state: State,
                                    phoretic_cfg, output_name, *, c=None,
                                    suffix=""):
    """Evaluate the phoretic concentration field on the grid and write
    `output_name + suffix + ".concentration_field.vtk"`; c optionally
    reuses a solved surface concentration. Returns the field (P,) as
    numpy."""
    from . import phoretic as ph

    coords, mesh, _ = velocity_field_grid(grid_spec)
    c_grid, _ = ph.concentration_field(system, state, phoretic_cfg, coords,
                                       c=c)
    c_grid = c_grid.cpu().numpy()
    vtk.write_rectilinear_mesh(
        output_name + suffix + ".concentration_field.vtk",
        mesh[0], mesh[1], mesh[2], [("concentration", 1, c_grid.ravel())])
    return c_grid


def plot_velocity_field_to_vtk(grid_spec, system: System, state: State, lam,
                               output_name, tracer_radius=0.0):
    """Evaluate the velocity field of blob forces lam on the grid and write
    `output_name + ".velocity_field.vtk"`. Returns the field (P, 3) as
    numpy."""
    coords, mesh, _ = velocity_field_grid(grid_spec)
    vel = evaluate_velocity_field(system, state, lam, coords,
                                  tracer_radius=tracer_radius).cpu().numpy()
    vtk.write_rectilinear_mesh(
        output_name + ".velocity_field.vtk", mesh[0], mesh[1], mesh[2],
        [("velocity", 3, vel.ravel())])
    return vel
