"""The port's counterparts of ``samples/``: narrate a video file (or an
interleaved run of videos and texts) with a checkpoint on the card. Each
module's ``main`` reads its videos through the native decoder and calls a
``run`` that takes frames."""
