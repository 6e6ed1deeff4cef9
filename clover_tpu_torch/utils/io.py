"""Small IO facade: pkl/json/jsonl helpers with local-or-remote hook.

Role of the reference's de-HDFS'd ``h*`` filesystem facade
(mmaction/utils/my_io.py:21-160): one place where storage access can be
swapped (e.g. for GCS via fsspec) without touching call sites.

Port of ``clover_tpu/utils/io.py``: a copy, held against it by ``tests/test_torch_trainer.py``.
"""

from __future__ import annotations

import glob as _glob
import json
import os
import pickle
from typing import Any, Iterable, List


def hexists(path: str) -> bool:
    return os.path.exists(path)


def hglob(pattern: str) -> List[str]:
    return sorted(_glob.glob(pattern))

def hmkdir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def hload_pkl(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def hsave_pkl(obj: Any, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def hload_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def hsave_json(obj: Any, path: str, indent: int = 2) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=indent)


def hload_jsonl(path: str) -> List[Any]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def hsave_jsonl(rows: Iterable[Any], path: str) -> None:
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
