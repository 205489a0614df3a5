"""Scene-file readers and writers: the reference's .vertex and .clones
formats, unchanged.

Counterpart of rigidmultiblobswall_tpu/io/scene.py (vertex and clones
read/write). The .slip, .const and .list_vertex readers are still to be
ported with the features that use them (ROADMAP Queue 1, item 18).
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


def write_clones_file(path, locations, quaternions):
    """Write a .clones snapshot in the reference output format."""
    locations = np.asarray(locations).reshape(-1, 3)
    quaternions = np.asarray(quaternions).reshape(-1, 4)
    with open(path, "w") as f:
        f.write(f"{len(locations)}\n")
        for x, q in zip(locations, quaternions):
            f.write("%s %s %s %s %s %s %s\n" % (
                x[0], x[1], x[2], q[0], q[1], q[2], q[3]))
