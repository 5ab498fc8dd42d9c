"""Serving layer of the port: continuous batching over fixed-shape slots
(``engine.py``), multi-turn chat sessions with incremental prefill
(``session.py``) and the cross-request video-feature cache."""

from .engine import Completion, ContinuousBatchingEngine, Request
from .feature_cache import VideoFeatureCache
from .session import ChatSession

__all__ = [
    "ChatSession",
    "Completion",
    "ContinuousBatchingEngine",
    "Request",
    "VideoFeatureCache",
]
