"""Scene-file readers and writers: the reference's .vertex, .clones,
.slip, velocity, .const and .list_vertex formats, unchanged.

Counterpart of rigidmultiblobswall_tpu/io/scene.py (the CLI reads its
velocity_file with np.loadtxt, as the JAX CLI does).
"""

from __future__ import annotations

import numpy as np


def _data_lines(path):
    with open(path, "r") as f:
        for line in f:
            if "#" in line:
                line = line.split("#", 1)[0]
            line = line.strip()
            if line:
                yield line


def read_vertex_file(path):
    """Blob reference coordinates, (Nblobs, 3) or (Nblobs, 4) with a
    per-blob radius column."""
    lines = list(_data_lines(path))
    n = int(lines[0].split()[0])
    coor = np.array([np.array(l.split(), dtype=np.float64)
                     for l in lines[1:]])
    return coor[:n] if len(coor) > n else coor


def read_clones_file(path):
    """Initial body locations and orientations: (num_bodies, locations
    (B,3), quaternions (B,4) normalized)."""
    lines = list(_data_lines(path))
    n = int(lines[0].split()[0])
    data = np.array([np.array(l.split(), dtype=np.float64)
                     for l in lines[1:n + 1]])
    q = data[:, 3:7]
    return n, data[:, 0:3], q / np.linalg.norm(q, axis=1, keepdims=True)


def read_slip_file(path):
    """Active slip in the body reference frame, (Nblobs, 3)."""
    lines = list(_data_lines(path))
    n = int(lines[0].split()[0])
    return np.array([np.array(l.split(), dtype=np.float64)[:3]
                     for l in lines[1:n + 1]])


def read_velocity_file(path):
    """Prescribed body velocities, (Nbodies, 6)."""
    lines = list(_data_lines(path))
    n = int(lines[0].split()[0])
    return np.array([np.array(l.split(), dtype=np.float64)[:6]
                     for l in lines[1:n + 1]])


def read_constraints_file(path):
    """Articulated-body constraints. Format:
      line0: number of rigid bodies
      line1: number of constraints
      then per constraint: body_i body_j  link (6 floats)  [extra...]
    Returns (num_bodies, num_constraints, indices (C,2) int, links (C,6)
    float, extra: per constraint the list of its further strings, the
    time-dependent link expressions)."""
    lines = list(_data_lines(path))
    num_bodies = int(lines[0].split()[0])
    num_constraints = int(lines[1].split()[0])
    indices, links, extra = [], [], []
    for l in lines[2:2 + num_constraints]:
        parts = l.split()
        indices.append([int(parts[0]), int(parts[1])])
        links.append([float(x) for x in parts[2:8]])
        extra.append(parts[8:])
    return (num_bodies, num_constraints, np.array(indices, dtype=int),
            np.array(links, dtype=float), extra)


def read_vertex_file_list(path):
    """A .list_vertex file: one vertex-file path per line; returns the
    list of reference configurations. The paths inside resolve against
    the working directory, not the list file's directory, as the JAX
    package and the reference resolve them: run from the directory the
    list was written for."""
    return [read_vertex_file(l.split()[0]) for l in _data_lines(path)]


def write_clones_file(path, locations, quaternions):
    """Write a .clones snapshot in the reference output format."""
    locations = np.asarray(locations).reshape(-1, 3)
    quaternions = np.asarray(quaternions).reshape(-1, 4)
    with open(path, "w") as f:
        f.write(f"{len(locations)}\n")
        for x, q in zip(locations, quaternions):
            f.write("%s %s %s %s %s %s %s\n" % (
                x[0], x[1], x[2], q[0], q[1], q[2], q[3]))
