"""JSON manifest handling.

Preserves the reference's data contract: a JSON of split-name -> list of
"<case>/merge.npy" relative paths (data/Multi_all.json), and the
list-replication trick where one loader "epoch" equals `eval_epoch` dataset
passes (main_source.py:123-131,186 — filedict_from_json(path, key, eval_epoch)).
"""

from __future__ import annotations

import json
import re
from typing import List


def filedict_from_json(json_path: str, key: str, epoch: int = 1) -> List[str]:
    """Replicates main_source.py:123-131: the split list, repeated `epoch`x."""
    with open(json_path, "r") as f:
        json_dict = json.load(f)
    listdict = json_dict.get(key, [])
    output: List[str] = []
    for _ in range(epoch):
        output += listdict
    return output


def case_id(manifest_entry: str) -> str:
    """Numeric case id extracted from the manifest path, as in
    utils/utils.py:349."""
    return "".join(re.findall(r"\d+", manifest_entry))
