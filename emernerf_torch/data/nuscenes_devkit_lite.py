"""Minimal, dependency-free reader of the nuScenes table layout (copy of
``emernerf_tpu/data/nuscenes_devkit_lite.py``, numpy-free and JAX-free).

The nuScenes loader (``emernerf_torch/data/nuscenes.py``) walks sample
tokens only to build its meta cache.  Where the ``nuscenes-devkit`` is not
installed, this class stands in for the slice of
``nuscenes.nuscenes.NuScenes`` that the walk touches, read from the
on-disk schema (``{dataroot}/{version}/{table}.json``):

* tables loaded: scene, sample, sample_data, calibrated_sensor, ego_pose,
  sensor;
* ``get(table, token)`` token lookup;
* the devkit's reverse index: raw ``sample`` records carry no ``data``
  field; the devkit fills ``sample["data"][channel] = sample_data.token``
  for key frames in ``__make_reverse_index__``; reproduced here, including
  the ``channel`` / ``sensor_modality`` attributes stamped onto
  sample_data records.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

TABLES = (
    "scene", "sample", "sample_data", "calibrated_sensor", "ego_pose",
    "sensor",
)


class NuScenesLite:
    """Drop-in for the devkit's ``NuScenes`` for token-walk purposes."""

    def __init__(self, version: str, dataroot: str, verbose: bool = False):
        self.version = version
        self.dataroot = dataroot
        table_dir = os.path.join(dataroot, version)
        if not os.path.isdir(table_dir):
            raise FileNotFoundError(
                f"nuScenes table directory not found: {table_dir}"
            )
        self._tables: Dict[str, List[dict]] = {}
        self._index: Dict[str, Dict[str, dict]] = {}
        for table in TABLES:
            with open(os.path.join(table_dir, f"{table}.json")) as f:
                records = json.load(f)
            self._tables[table] = records
            self._index[table] = {r["token"]: r for r in records}
        self.__make_reverse_index__()

    # devkit-compatible surface ---------------------------------------- #
    @property
    def scene(self) -> List[dict]:
        return self._tables["scene"]

    def get(self, table: str, token: str) -> dict:
        return self._index[table][token]

    # ------------------------------------------------------------------ #
    def __make_reverse_index__(self) -> None:
        """sample['data'][channel] -> key-frame sample_data token, plus
        channel/modality stamps, as the devkit does."""
        for sample in self._tables["sample"]:
            sample.setdefault("data", {})
        for sd in self._tables["sample_data"]:
            calib = self.get("calibrated_sensor", sd["calibrated_sensor_token"])
            sensor = self.get("sensor", calib["sensor_token"])
            sd["channel"] = sensor["channel"]
            sd["sensor_modality"] = sensor["modality"]
            if sd["is_key_frame"]:
                sample = self.get("sample", sd["sample_token"])
                sample["data"][sd["channel"]] = sd["token"]
