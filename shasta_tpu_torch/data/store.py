"""Run-directory stage store: named-array manifest checkpointing.

The reference's memory-mapped ``Data/`` namespace doubles as its
checkpoint format — every pipeline stage persists named binary files
(e.g. ``Markers-0.bin``) and any stage can be re-run in isolation by
re-attaching to them (reference: src/MemoryMappedVector.hpp:72-97,
srcMain/main.cpp:1219-1285, Assembler::accessAllSoft at
src/Assembler.hpp:2341). This module provides the same property for
the port: each stage saves a dict of named numpy arrays under
``<run_dir>/Data/<stage>/``, recorded in ``manifest.json``; stages can
be reloaded individually, so the store is both the checkpoint and the
integration-test harness.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Dict, List, Optional

import numpy as np


class RunStore:
    MANIFEST = "manifest.json"

    def __init__(self, run_dir: str, create: bool = True):
        self.run_dir = run_dir
        self.data_dir = os.path.join(run_dir, "Data")
        if create:
            os.makedirs(self.data_dir, exist_ok=True)
        self._manifest = self._load_manifest()

    # ----- manifest -----
    def _manifest_path(self) -> str:
        return os.path.join(self.data_dir, self.MANIFEST)

    def _load_manifest(self) -> Dict:
        p = self._manifest_path()
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return {"stages": {}}

    def _save_manifest(self) -> None:
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._manifest, f, indent=2, sort_keys=True)
        os.replace(tmp, self._manifest_path())

    # ----- stages -----
    def stage_names(self) -> List[str]:
        return sorted(self._manifest["stages"].keys())

    def has_stage(self, stage: str) -> bool:
        return stage in self._manifest["stages"]

    def save_stage(self, stage: str, arrays: Dict[str, np.ndarray]) -> None:
        sdir = os.path.join(self.data_dir, stage)
        os.makedirs(sdir, exist_ok=True)
        names = []
        for name, arr in arrays.items():
            arr = np.asarray(arr)
            np.save(os.path.join(sdir, f"{name}.npy"), arr)
            names.append(name)
        self._manifest["stages"][stage] = {
            "arrays": sorted(names),
            "time": time.time(),
        }
        self._save_manifest()

    def load_stage(self, stage: str) -> Dict[str, np.ndarray]:
        if not self.has_stage(stage):
            raise KeyError(f"Stage {stage!r} not present in {self.data_dir}")
        sdir = os.path.join(self.data_dir, stage)
        out = {}
        for name in self._manifest["stages"][stage]["arrays"]:
            out[name] = np.load(os.path.join(sdir, f"{name}.npy"), allow_pickle=False)
        return out

    def remove_stage(self, stage: str) -> None:
        sdir = os.path.join(self.data_dir, stage)
        if os.path.isdir(sdir):
            shutil.rmtree(sdir)
        self._manifest["stages"].pop(stage, None)
        self._save_manifest()

    # ----- scalars / metadata -----
    def save_info(self, key: str, value) -> None:
        info = self._manifest.setdefault("info", {})
        info[key] = value
        self._save_manifest()

    def get_info(self, key: str, default=None):
        return self._manifest.get("info", {}).get(key, default)
