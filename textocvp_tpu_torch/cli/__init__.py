"""Command-line entry points of the port (01, 02, 03, 04, 05, 07, and the
checkpoint importer)."""

import os


def resolve_exp_dir(path: str) -> str:
    """``path`` as given when it is absolute or exists, else under
    ``$TEXTOCVP_EXPERIMENTS`` (default ``./experiments``)."""
    if os.path.isabs(path) or os.path.exists(path):
        return path
    root = os.environ.get("TEXTOCVP_EXPERIMENTS", os.path.join(os.getcwd(), "experiments"))
    return os.path.join(root, path)
