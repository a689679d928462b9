"""The scenes shipped in the repo's data/models directory.

`.blob` scenes live under data/models/blobtree/ and `.sim` configs under
data/models/; tools/make_fixtures.py and tools/make_brain.py write them.
A scene that is not there is an error, never a silent skip.
"""
from __future__ import annotations

from pathlib import Path

MODELS_DIR = Path(__file__).resolve().parent.parent / "data" / "models"


def _existing(path: Path) -> Path:
    if not path.exists():
        raise FileNotFoundError(
            f"{path} is not in the repo's data/models (generated by "
            "tools/make_fixtures.py and tools/make_brain.py)"
        )
    return path


def blob_path(name: str) -> Path:
    """Path of data/models/blobtree/<name>.blob."""
    return _existing(MODELS_DIR / "blobtree" / f"{name}.blob")


def sim_path(name: str) -> Path:
    """Path of data/models/<name>.sim."""
    return _existing(MODELS_DIR / f"{name}.sim")


def load_scene(name: str):
    """Load, flatten instances and pack data/models/blobtree/<name>.blob."""
    from .blob.reader import load_blob

    sc = load_blob(blob_path(name))
    sc.flatten_instances()
    return sc.pack()
