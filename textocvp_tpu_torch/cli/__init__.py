"""Command-line entry points of the port: 01 (``create_experiment``,
``create_predictor_experiment``), 02 (``train_decomp``), 03
(``evaluate_decomp``), 04 (``train_predictor``), 05 (``evaluate_predictor``),
06 (``generate_figs_decomp``, ``generate_figs_predictor``), 07 (``serve``),
the checkpoint importer and the ``.npy`` cache builder."""

import os


def resolve_exp_dir(path: str) -> str:
    """``path`` as given when it is absolute or exists, else under
    ``$TEXTOCVP_EXPERIMENTS`` (default ``./experiments``)."""
    if os.path.isabs(path) or os.path.exists(path):
        return path
    root = os.environ.get("TEXTOCVP_EXPERIMENTS", os.path.join(os.getcwd(), "experiments"))
    return os.path.join(root, path)
