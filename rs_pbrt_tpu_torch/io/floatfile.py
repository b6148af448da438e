"""Float files: whitespace-separated numbers with '#' comments, as a lens
file or an .spd spectrum holds them (reference src/core/floatfile.rs).
The port's copy of the JAX package's ``io/floatfile.py``."""

from __future__ import annotations

from pathlib import Path


def read_float_file(path) -> list:
    """Every number of the file at path, in order, as Python floats."""
    vals = []
    for line in Path(path).read_text().splitlines():
        line = line.split("#", 1)[0]
        for tok in line.split():
            vals.append(float(tok))
    return vals
