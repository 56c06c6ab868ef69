"""The assigned (architecture × shape) grid.

:func:`all_cells` lists every cell of the registry: 40 for the ten
assigned architectures, 43 with the paper's own ``repair-ir``.  The
reference's lowering specs (one per cell, for its dry run) wait for the
port's meta-device dry run.
"""

from __future__ import annotations

from ..configs import get_arch, list_archs


def all_cells(include_repair_ir: bool = True) -> list[tuple[str, str]]:
    """The 40 assigned cells (+ the paper's own arch if requested)."""
    cells = []
    for a in list_archs():
        arch = get_arch(a)
        if arch.family == "repair_ir" and not include_repair_ir:
            continue
        for s in arch.shapes:
            cells.append((a, s.name))
    return cells
