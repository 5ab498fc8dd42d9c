"""Narration text cleaning and small text utilities (a copy of
``eilev_tpu/data/text.py``, kept here because the port imports nothing of
``eilev_tpu``).

Parity target: the original EILeV's eilev/data/utils.py:13-16,69-92,229-241 - the exact
regex pipeline the Ego4D narrations go through before tokenization, which the
golden-token tests treat as part of the data contract.
"""

from __future__ import annotations

import re
import string
from collections.abc import Iterable
from typing import TypeVar

C_REGEX = re.compile(r"^\#C\s+C", re.IGNORECASE)
EOS_REGEX = re.compile(r"\<\|eos\|\>$", re.IGNORECASE)
UNSURE_END_REGEX = re.compile(r"#unsure\.?$", re.IGNORECASE)
UNSURE_MIDDLE_REGEX = re.compile(r"#unsure", re.IGNORECASE)


def clean_narration_text(narration_text: str) -> str:
    """'#C C drops the knife #unsure' -> 'The camera wearer drops the knife something.'

    Steps (order matters): strip; '#C C' prefix -> 'The camera wearer'; trailing
    '<|eos|>' removed; trailing '#unsure' removed; interior '#unsure' ->
    'something'; ensure trailing punctuation.
    """
    cleaned = narration_text.strip()
    cleaned = re.sub(C_REGEX, "The camera wearer", cleaned).strip()
    cleaned = re.sub(EOS_REGEX, "", cleaned).strip()
    cleaned = re.sub(UNSURE_END_REGEX, "", cleaned).strip()
    cleaned = re.sub(UNSURE_MIDDLE_REGEX, "something", cleaned)
    if len(cleaned) == 0:
        return cleaned
    if cleaned[-1] not in string.punctuation:
        cleaned += "."
    return cleaned


T = TypeVar("T")


def generate_chunks(list_to_chunk: list[T], chunk_size: int) -> Iterable[list[T]]:
    for i in range(0, len(list_to_chunk), chunk_size):
        yield list_to_chunk[i : i + chunk_size]


def parse_timestamp(timestamp: str) -> float:
    """'hh:mm:ss.cc' -> seconds."""
    hours, minutes, seconds = timestamp.split(":")
    return float(hours) * 60 * 60 + float(minutes) * 60 + float(seconds)
