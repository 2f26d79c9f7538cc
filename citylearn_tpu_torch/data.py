"""Dataset catalog (reference ``citylearn/data.py:31-293`` ``DataSet``).

A named dataset resolves to a local directory holding its
``schema.json``, searched in order: ``CITYLEARN_DATA_ROOT`` (an environment
variable), the ``data/datasets`` directory of an installed reference
``citylearn`` package (found without importing it), and the user cache
``~/.cache/citylearn_tpu/datasets``. Nothing is downloaded: a name found
in no root raises ``FileNotFoundError`` listing the roots searched.
"""

from __future__ import annotations

import importlib.util
import json
import os
from pathlib import Path
from typing import List, Optional


def _reference_roots() -> List[str]:
    """``data/datasets`` beside or inside an installed ``citylearn`` package."""
    try:
        spec = importlib.util.find_spec("citylearn")
    except (ImportError, ValueError):
        return []
    if spec is None or not spec.origin:
        return []
    package = os.path.dirname(spec.origin)
    return [os.path.join(package, "data", "datasets"),
            os.path.join(os.path.dirname(package), "data", "datasets")]


def default_roots() -> List[str]:
    """The roots searched when :class:`DataSet` is given none, read when called."""
    return [r for r in [os.environ.get("CITYLEARN_DATA_ROOT"), *_reference_roots(),
                        os.path.join(str(Path.home()), ".cache", "citylearn_tpu", "datasets")]
            if r]


class DataSet:
    # reference citylearn/data.py:42-43
    BATTERY_CHOICES_FILENAME = "battery_choices.yaml"
    PV_CHOICES_FILENAME = "lbl-tracking_the_sun-res-pv.csv"

    def __init__(self, roots: Optional[List[str]] = None):
        self.roots = [r for r in (roots or default_roots()) if r]

    # -- sizing data (reference data.py:191-259) ------------------------
    def get_battery_sizing_data(self):
        """The reference reads its bundled ``battery_choices.yaml`` to
        autosize batteries; the port's compiler does not autosize and the
        repository does not carry the file."""
        raise NotImplementedError(
            f"battery sizing data ({self.BATTERY_CHOICES_FILENAME}) is not in the repository "
            "and the port's compiler does not autosize: give the battery's capacity and "
            "nominal power in the schema")

    def get_pv_sizing_data(self):
        """As :meth:`get_battery_sizing_data`, for the PV sample of the reference."""
        raise NotImplementedError(
            f"PV sizing data ({self.PV_CHOICES_FILENAME}) is not in the repository and the "
            "port's compiler does not autosize: give the PV's nominal power in the schema")

    # -- datasets -------------------------------------------------------
    def get_dataset_names(self) -> List[str]:
        names = set()
        for root in self.roots:
            if os.path.isdir(root):
                for d in os.listdir(root):
                    if os.path.isfile(os.path.join(root, d, "schema.json")):
                        names.add(d)
        return sorted(names)

    def get_dataset(self, name: str) -> str:
        """The directory of dataset ``name``: the first root that holds it."""
        for root in self.roots:
            path = os.path.join(root, name)
            if os.path.isfile(os.path.join(path, "schema.json")):
                return path
        raise FileNotFoundError(
            f"dataset {name!r} was found in none of the roots {self.roots}; nothing is "
            f"downloaded: set CITYLEARN_DATA_ROOT to a directory holding "
            f"{name}/schema.json, or pass the schema's path")

    def get_schema(self, name: str) -> dict:
        path = self.get_dataset(name)
        with open(os.path.join(path, "schema.json")) as f:
            schema = json.load(f)
        schema["root_directory"] = path
        return schema

    def get_schema_path(self, name: str) -> str:
        return os.path.join(self.get_dataset(name), "schema.json")
