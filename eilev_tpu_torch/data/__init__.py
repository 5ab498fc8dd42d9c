"""The jax-free data modules, copied from ``eilev_tpu/data`` (the port imports
nothing of ``eilev_tpu``): prompt builders, collators, narration text
cleaning and the frame datasets."""

from .collate import DataCollatorForInterleavedVideoSeq2Seq, DataCollatorForVideoSeq2Seq
from .frame import (
    FrameDataset,
    FrameInterleavedDataset,
    FrameInterleavedPresampledDataset,
)
from .prompts import (
    IGNORE_INDEX,
    generate_input_ids_and_labels,
    generate_input_ids_and_labels_from_interleaved,
)
from .text import clean_narration_text, generate_chunks, parse_timestamp

__all__ = [
    "DataCollatorForInterleavedVideoSeq2Seq",
    "DataCollatorForVideoSeq2Seq",
    "FrameDataset",
    "FrameInterleavedDataset",
    "FrameInterleavedPresampledDataset",
    "IGNORE_INDEX",
    "clean_narration_text",
    "generate_chunks",
    "generate_input_ids_and_labels",
    "generate_input_ids_and_labels_from_interleaved",
    "parse_timestamp",
]
