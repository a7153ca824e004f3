"""Cut manifests: a lhotse-schema-compatible subset, dependency-free (a
copy of `dmel_codec_tpu/data/manifest.py`; host code without JAX).

`load_manifest` reads BOTH this flat schema and lhotse MonoCut jsonl.gz
lines (id/start/duration/recording.sources[0].source/
supervisions[0].text), so manifests produced for the original reference
keep working.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import os
from typing import Iterable, List, Optional


@dataclasses.dataclass
class Cut:
    id: str
    audio_path: str
    start: float = 0.0
    duration: float = 0.0
    sampling_rate: int = 24000
    text: Optional[str] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "Cut":
        if "audio_path" in d:  # flat schema
            known = {f.name for f in dataclasses.fields(Cut)}
            return Cut(**{k: v for k, v in d.items() if k in known})
        # lhotse MonoCut schema
        rec = d.get("recording", {})
        sources = rec.get("sources", [])
        path = sources[0]["source"] if sources else rec.get("path", "")
        sups = d.get("supervisions", [])
        return Cut(
            id=d.get("id", path),
            audio_path=path,
            start=float(d.get("start", 0.0)),
            duration=float(d.get("duration", rec.get("duration", 0.0))),
            sampling_rate=int(rec.get("sampling_rate", 24000)),
            text=sups[0].get("text") if sups else None,
        )


def _open(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode + "t")
    return open(path, mode)


def load_manifest(path: str) -> List[Cut]:
    cuts = []
    with _open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line:
                cuts.append(Cut.from_dict(json.loads(line)))
    return cuts


def save_manifest(cuts: Iterable[Cut], path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with _open(path, "w") as f:
        for cut in cuts:
            f.write(json.dumps(cut.to_dict()) + "\n")
