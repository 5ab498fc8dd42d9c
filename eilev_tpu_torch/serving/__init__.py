"""Serving layer of the port: the cross-request video-feature cache."""

from .feature_cache import VideoFeatureCache

__all__ = ["VideoFeatureCache"]
