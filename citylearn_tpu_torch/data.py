"""Dataset catalog (reference ``citylearn/data.py:31-293`` ``DataSet``).

A named dataset resolves to a local directory holding its
``schema.json``, searched in order: ``CITYLEARN_DATA_ROOT`` (an environment
variable), the ``data/datasets`` directory of an installed reference
``citylearn`` package (found without importing it), and the user cache
``~/.cache/citylearn_tpu/datasets``. Nothing is downloaded: a name found
in no root raises ``FileNotFoundError`` listing the roots searched.

The autosize's sizing files (``battery_choices.yaml``, the LBL PV sample)
are searched in ``CITYLEARN_MISC_ROOT``, then in the ``data/misc``
directory of an installed reference ``citylearn`` package.
"""

from __future__ import annotations

import importlib.util
import json
import os
from pathlib import Path
from typing import Dict, List, Optional


def _reference_roots(kind: str = "datasets") -> List[str]:
    """``data/<kind>`` beside or inside an installed ``citylearn`` package."""
    try:
        spec = importlib.util.find_spec("citylearn")
    except (ImportError, ValueError):
        return []
    if spec is None or not spec.origin:
        return []
    package = os.path.dirname(spec.origin)
    return [os.path.join(package, "data", kind),
            os.path.join(os.path.dirname(package), "data", kind)]


def misc_file(filename: str) -> Optional[str]:
    """The first of ``CITYLEARN_MISC_ROOT`` and the reference package's
    ``data/misc`` that holds ``filename``, read when called; else None."""
    for root in [os.environ.get("CITYLEARN_MISC_ROOT"), *_reference_roots("misc")]:
        if root and os.path.isfile(os.path.join(root, filename)):
            return os.path.join(root, filename)
    return None


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
    def get_battery_sizing_data(self) -> Dict[str, list]:
        """Real-world battery manufacturer models from ``battery_choices.yaml``
        (:func:`misc_file`): the column ``model`` and one column per
        attribute, in the file's order (reference ``data.py:224-259``,
        there a DataFrame indexed by model)."""
        from citylearn_tpu_torch.compiler.schema import read_battery_choices

        return read_battery_choices()

    def get_pv_sizing_data(self) -> Dict[str, object]:
        """The LBL Tracking-the-Sun residential-PV sample as numpy columns
        when a local copy is found, else the seeded synthetic stand-in
        (reference ``data.py:191-226`` downloads it)."""
        from citylearn_tpu_torch.compiler.pv_autosize import get_pv_sizing_data

        return get_pv_sizing_data()

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
