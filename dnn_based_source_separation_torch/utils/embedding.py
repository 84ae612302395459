"""Speaker indexing: the stable string-to-row mapping of Wavesplit's speaker-embedding table.

The port's own copy of `dnn_based_source_separation_tpu/utils/embedding.py`
(`SpeakerToIndex`, after the reference `src/utils/embedding.py:3`): the first
`add` of a speaker fixes its row.
"""
from __future__ import annotations

from typing import Dict, Iterable


class SpeakerToIndex:
    def __init__(self, speakers: Iterable[str] = ()):
        self._table: Dict[str, int] = {}
        for s in speakers:
            self.add(s)

    def add(self, speaker: str) -> int:
        if speaker not in self._table:
            self._table[speaker] = len(self._table)
        return self._table[speaker]

    def __call__(self, speaker: str) -> int:
        if speaker not in self._table:
            raise KeyError(f"Unknown speaker: {speaker}")
        return self._table[speaker]

    def __len__(self) -> int:
        return len(self._table)

    @property
    def speakers(self):
        return list(self._table)
