"""The native libav video decoder (counterpart of ``eilev_tpu/native``)."""

from .decoder import VideoDecoder, decoder_available

__all__ = ["VideoDecoder", "decoder_available"]
