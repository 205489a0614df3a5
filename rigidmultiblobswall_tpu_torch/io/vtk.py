"""Legacy-VTK rectilinear-grid writer (host-side I/O only).

Counterpart of rigidmultiblobswall_tpu/io/vtk.py, with the same file
layout: a rectilinear grid with cell-centred variables, readable by VisIt
and ParaView; the header's second line names this package.
"""

from __future__ import annotations

import numpy as np


def write_rectilinear_mesh(path, xmesh, ymesh, zmesh, variables):
    """variables: list of (name, ncomponents, flat_array) with zonal
    (cell-centred) data ordered x-fastest."""
    xmesh = np.asarray(xmesh, dtype=float)
    ymesh = np.asarray(ymesh, dtype=float)
    zmesh = np.asarray(zmesh, dtype=float)
    n_cells = (max(len(xmesh) - 1, 1) * max(len(ymesh) - 1, 1)
               * max(len(zmesh) - 1, 1))

    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write("Written by rigidmultiblobswall_tpu_torch\n")
        f.write("ASCII\n")
        f.write("DATASET RECTILINEAR_GRID\n")
        f.write("DIMENSIONS %d %d %d\n" % (len(xmesh), len(ymesh),
                                          len(zmesh)))
        for label, mesh in (("X", xmesh), ("Y", ymesh), ("Z", zmesh)):
            f.write("%s_COORDINATES %d float\n" % (label, len(mesh)))
            f.write(" ".join("%g" % v for v in mesh) + "\n")
        f.write("CELL_DATA %d\n" % n_cells)
        for name, ncomp, data in variables:
            data = np.asarray(data, dtype=float).reshape(-1, ncomp)
            if ncomp == 3:
                f.write("VECTORS %s float\n" % name)
                for row in data:
                    f.write("%g %g %g\n" % tuple(row))
            else:
                f.write("SCALARS %s float\n" % name)
                f.write("LOOKUP_TABLE default\n")
                for row in data:
                    f.write("%g\n" % row[0])
