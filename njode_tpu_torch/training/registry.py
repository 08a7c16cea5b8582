"""Model registry: ``model_overview.csv`` mapping id -> JSON param description.

The JSON description doubles as the config store; an existing id means
resume with the saved parameters. Same file layout as the JAX package's
registry (pandas' ``to_csv``), written with the ``csv`` module; one process
at a time."""

from __future__ import annotations

import json
import os

from njode_tpu_torch.utils.csv_frame import read_frame, write_frame
from njode_tpu_torch.utils.paths import makedirs

_COLUMNS = ["id", "description"]


def overview_file(saved_models_path: str) -> str:
    return os.path.join(saved_models_path, "model_overview.csv")


def load_overview(saved_models_path: str):
    """Rows ``[id (int), description (str)]``."""
    makedirs(saved_models_path)
    f = overview_file(saved_models_path)
    if not os.path.exists(f):
        return []
    _, rows = read_frame(f)
    return [[int(float(i)), d] for i, d in rows]


def register_model(saved_models_path: str, model_id, desc: str):
    rows = load_overview(saved_models_path)
    write_frame(overview_file(saved_models_path), _COLUMNS,
                rows + [[int(model_id), desc]])


def resolve_model_id(saved_models_path: str, model_id, desc: str):
    """None -> next free id, registered; an existing id -> resume with the
    *saved* description.

    :return: (model_id, desc, params_dict_from_desc_or_None, resume: bool)
    """
    rows = load_overview(saved_models_path)
    ids = [r[0] for r in rows]
    if model_id is None:
        model_id = (max(ids) if ids else 0) + 1
    if model_id not in ids:
        register_model(saved_models_path, model_id, desc)
        return model_id, desc, None, False
    saved_desc = rows[ids.index(model_id)][1]
    return model_id, saved_desc, json.loads(saved_desc), True
