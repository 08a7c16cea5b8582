"""Filesystem layout for datasets, saved models, and registries.

The same layout as ``njode_tpu/utils/paths.py`` — rooted at the repo (or
``NJODE_DATA_PATH``) — so the two packages share datasets on disk."""

import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

data_path = os.environ.get("NJODE_DATA_PATH",
                           os.path.join(_REPO_ROOT, "data"))
training_data_path = os.path.join(data_path, "training_data")
saved_models_path = os.path.join(data_path, "saved_models")


def makedirs(dirname):
    os.makedirs(dirname, exist_ok=True)
