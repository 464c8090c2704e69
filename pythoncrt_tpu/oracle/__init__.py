"""CPU ground-truth oracle: exact NumPy re-implementation of the effect
chain. Defines the reference bytes the device engine is tested against."""

from . import ops
from .engine import (
    apply_effects,
    apply_color_adjustments,
    apply_triad,
    apply_glitch_gather,
    barrel_warp_maps,
    composite_text,
    flicker_factor,
    glitch_fields_export,
    glitch_offsets_preview,
    glitch_rows,
    persistence_blend,
    pixelate_index_maps,
    scanline_mask_1d,
    scanline_mask_2d,
    scanline_slant,
    triad_luts,
    triad_mask,
    vignette_mask,
)
from .render import render_oracle

__all__ = [
    "ops",
    "apply_effects",
    "apply_color_adjustments",
    "apply_triad",
    "apply_glitch_gather",
    "barrel_warp_maps",
    "composite_text",
    "flicker_factor",
    "glitch_fields_export",
    "glitch_offsets_preview",
    "glitch_rows",
    "persistence_blend",
    "pixelate_index_maps",
    "render_oracle",
    "scanline_mask_1d",
    "scanline_mask_2d",
    "scanline_slant",
    "triad_luts",
    "triad_mask",
    "vignette_mask",
]
