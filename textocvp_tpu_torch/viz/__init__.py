"""Figures and GIFs of the port, drawn with PIL (``viz/figures.py``)."""

from textocvp_tpu_torch.viz.figures import (
    COLORS,
    GREEN,
    RED,
    Figure,
    add_border,
    idx_to_one_hot,
    make_gif,
    masks_to_rgb,
    overlay_segmentations,
    panel_pixels,
    process_objs_masks_dinosaur,
    visualize_aligned_slots,
    visualize_decomp,
    visualize_metric,
    visualize_qualitative_eval,
    visualize_recons,
    visualize_sequence,
)

__all__ = ["COLORS", "GREEN", "RED", "Figure", "add_border", "idx_to_one_hot", "make_gif",
           "masks_to_rgb", "overlay_segmentations", "panel_pixels",
           "process_objs_masks_dinosaur", "visualize_aligned_slots", "visualize_decomp",
           "visualize_metric", "visualize_qualitative_eval", "visualize_recons",
           "visualize_sequence"]
