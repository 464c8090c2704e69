"""Dependency checking (reference crt_filter.py:17-47, redesigned).

The reference pip-installs its requirements at IMPORT time and
invalidates import caches. On accelerator hosts that is the wrong behavior:
environments are pinned images, silent installs break reproducibility,
and a render farm must fail loudly, not mutate itself. The capability
is kept — one call reports exactly what is missing and how to get it —
but as an explicit diagnostic, never a side effect.

`python -m pythoncrt_tpu --check-deps` prints the report and exits 0/4.
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass

# (module, pip name, needed for)
_CORE = (
    ("numpy", "numpy", "everything"),
    ("jax", "jax", "the JAX/XLA engine"),
)
# video I/O needs an ffmpeg binary or OpenCV: OpenCV is required only
# where no ffmpeg binary is found
_VIDEO = ("cv2", "opencv-python-headless", "video decode/encode without ffmpeg")
_OPTIONAL = (
    ("PIL", "Pillow", "text overlay rasterization"),
    ("PySide6", "PySide6", "the Qt GUI (CLI works without it)"),
)


@dataclass(frozen=True)
class DepReport:
    missing_core: tuple
    missing_optional: tuple

    @property
    def ok(self) -> bool:
        return not self.missing_core

    def render(self) -> str:
        lines = []
        if self.ok and not self.missing_optional:
            return "all dependencies present"
        for mod, pip, why in self.missing_core:
            lines.append(f"MISSING (required): {mod} — {why}; install with "
                         f"`pip install {pip}`")
        for mod, pip, why in self.missing_optional:
            lines.append(f"missing (optional): {mod} — {why}; install with "
                         f"`pip install {pip}`")
        return "\n".join(lines)


def check_deps() -> DepReport:
    """Report missing dependencies WITHOUT importing them (find_spec
    only — no import-time side effects, unlike the reference)."""

    from .io.video import find_ffmpeg

    def missing(entries):
        return tuple(e for e in entries
                     if importlib.util.find_spec(e[0]) is None)

    if find_ffmpeg() is None:
        return DepReport(missing(_CORE + (_VIDEO,)), missing(_OPTIONAL))
    return DepReport(missing(_CORE), missing(_OPTIONAL + (_VIDEO,)))
